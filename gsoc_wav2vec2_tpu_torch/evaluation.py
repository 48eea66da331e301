"""Greedy-CTC inference (the inference half of
`gsoc_wav2vec2_tpu/evaluation.py::GreedyCTCEvaluator`).

Device side: forward + argmax.  Host side: CTC collapse + string join
(`Wav2Vec2Processor.decode`).  No mesh, no beam search, no timestamps and
no streaming in this slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .data.processor import Wav2Vec2Processor
from .models.modeling import default_compute_dtype, wav2vec2_for_ctc_forward


def plan_chunks(
    total_len: int,
    chunk: int,
    context: int,
    conv_output_length,
    total_stride: Optional[int] = None,
):
    """Window plan for long-form transcription (a copy of the JAX
    package's `plan_chunks`).

    Returns [(sample_start, keep_frame_lo, keep_frame_hi)] such that windows
    of `chunk` samples starting at `sample_start` cover the waveform, each
    overlapping its neighbours by ~`context` samples on both sides, and the
    kept frame ranges tile the audio EXACTLY: window starts are aligned to
    the conv stack's total stride, so local frame `j` of a window starting
    at `s` is global frame `s // total_stride + j`, and junctions are
    computed once in global frame space.  The final window's end uses
    `conv_output_length` so pad-influenced tail frames are excluded,
    matching the unchunked decode.
    """
    if chunk <= 2 * context:
        raise ValueError(f"chunk {chunk} must exceed 2x context {context}")
    f = lambda n: int(conv_output_length(int(n)))
    if total_stride is None:
        # f advances by exactly 1 every `total_stride` samples, so over a
        # span >> period the ratio rounds to it exactly
        span = max(chunk, 4096)
        count = f(2 * span) - f(span)
        if count <= 0:
            raise ValueError("conv_output_length produced no frames over a chunk")
        total_stride = max(1, round(span / count))
    stride = chunk - 2 * context
    plan = []
    start = 0  # center-region start (samples)
    prev_boundary = 0  # global frame index where the previous window stopped
    while start < total_len:
        win_start = max(0, start - context)
        win_start -= win_start % total_stride  # align to the frame grid
        base_frame = win_start // total_stride
        center_end = min(start + stride, total_len)
        keep_lo = prev_boundary - base_frame
        if center_end < total_len:
            keep_hi = min(center_end // total_stride - base_frame, f(chunk))
        else:
            keep_hi = f(min(total_len - win_start, chunk))
        if keep_hi > keep_lo:
            plan.append((win_start, keep_lo, keep_hi))
            prev_boundary = base_frame + keep_hi
        start = center_end
    return plan


class GreedyCTCEvaluator:
    """Greedy-decode inference for a `Wav2Vec2ForCTC` module, in its
    device's compute dtype (bf16 on the card, f32 on the CPU).  The robust
    family gets a sample mask; base checkpoints were trained without one."""

    def __init__(self, model):
        self.model = model
        self.config = model.config
        self.device = model.device
        self.compute_dtype = default_compute_dtype(self.device)
        self.tokenizer = Wav2Vec2Processor(is_tokenizer=True)
        self.use_attention_mask = self.config.is_robust

    def _step(self, speech: np.ndarray, mask: Optional[np.ndarray]):
        """Forward + argmax on the model's device; returns host numpy
        (ids (B, frames) int32, frame lengths (B,) or None without a mask)."""
        with torch.inference_mode():
            x = torch.from_numpy(speech).to(self.device)
            m = None if mask is None else torch.from_numpy(mask).to(self.device)
            logits = wav2vec2_for_ctc_forward(
                self.model, self.config, x, m, compute_dtype=self.compute_dtype
            )
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
            lengths = None
            if m is not None:
                lengths = self.config.conv_output_length(m.to(torch.int64).sum(dim=-1))
            ids = ids.cpu().numpy()
            return ids, None if lengths is None else lengths.cpu().numpy()

    def _device_outputs(self, speech: np.ndarray, sample_lengths: np.ndarray):
        """(ids, frame lengths clipped to [0, frames]): conv_output_length
        goes negative below ~25 samples on the 7-layer stack, and a
        negative slice bound would decode almost a full row."""
        l = speech.shape[1]
        mask = None
        if self.use_attention_mask:
            mask = (np.arange(l)[None, :] < sample_lengths[:, None]).astype(np.float32)
        ids, frame_lengths = self._step(speech, mask)
        if frame_lengths is None:
            # drop frames produced purely by padding
            frame_lengths = self.config.conv_output_length(sample_lengths)
        return ids, np.clip(np.asarray(frame_lengths), 0, ids.shape[1])

    def predict_batch(
        self, speech: np.ndarray, sample_lengths: Optional[np.ndarray] = None
    ) -> List[str]:
        """speech: (B, L) normalised waveforms; sample_lengths: true lengths
        (defaults to L for all rows)."""
        speech = np.ascontiguousarray(speech, np.float32)
        b, l = speech.shape
        if sample_lengths is None:
            sample_lengths = np.full((b,), l, np.int64)
        sample_lengths = np.asarray(sample_lengths, np.int64)
        ids, frame_lengths = self._device_outputs(speech, sample_lengths)
        return [self.tokenizer.decode(ids[i, : frame_lengths[i]]) for i in range(b)]

    def transcribe_long(
        self,
        audio: np.ndarray,
        chunk_samples: int = 246000,
        context_samples: int = 16000,
    ) -> str:
        """Transcribe audio of any length: windows of `chunk_samples` that
        overlap by `context_samples` on each side, each window's center
        frames kept (`plan_chunks`), one greedy collapse over the joined
        frame ids."""
        audio = np.asarray(audio, np.float32)
        if len(audio) <= chunk_samples:
            return self.predict_batch(audio[None, :])[0]
        plan = plan_chunks(
            len(audio), chunk_samples, context_samples,
            self.config.conv_output_length,
            total_stride=int(np.prod(self.config.strides)),
        )
        ids: List[np.ndarray] = []
        for start, keep_lo, keep_hi in plan:
            chunk = audio[start : start + chunk_samples]
            true_len = len(chunk)
            if true_len < chunk_samples:
                chunk = np.pad(chunk, (0, chunk_samples - true_len))
            mask = None
            if self.use_attention_mask:
                mask = (np.arange(chunk_samples) < true_len).astype(np.float32)[None, :]
            preds, _ = self._step(np.ascontiguousarray(chunk[None, :]), mask)
            ids.append(preds[0, keep_lo:keep_hi])
        return self.tokenizer.decode(np.concatenate(ids))
