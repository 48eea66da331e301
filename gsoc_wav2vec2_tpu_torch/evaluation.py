"""CTC inference and WER evaluation (counterpart of
`gsoc_wav2vec2_tpu/evaluation.py::GreedyCTCEvaluator`).

Device side: the forward and the step mode's reduction (argmax ids,
log-probs, or ids with their log-probs).  Host side: the greedy CTC
collapse or prefix beam search with optional LM fusion (`decoding.py`),
word timestamps and forced alignment.  `evaluate_padded` is the reference's
constant-pad mode, `evaluate_bucketed` groups samples into a handful of
length buckets so that padding within a batch stays bounded.

Several processes (`mesh`, a `parallel.Mesh` over the ranks): each rank
evaluates its own slice of the corpus on its own device (the loaders shard
by rank), in its own buckets and batches, so a sample decodes as it does in
one process; the WER is the corpus's, from one all-gather of each rank's
(errors, words, samples) at the end (`_aggregate_wer`).  The ranks step in
lockstep (`_lockstep`, as JAX's): one all-gather of a have-a-batch flag a
flush, and a rank whose slice ran dry runs a dummy batch, its result
discarded, until every rank is done.  JAX needs that because its ranks
build one global array a batch; the port's forward holds no collective
today (`cli.evaluate --sharded` builds a model=1 mesh), so lockstep keeps
the ranks' step counts equal and a forward that gains a collective safe.
JAX's `_row_quantum` and `_local_rows` have no counterpart: with one
process a device, a rank's rows are the rows it computed.

The sharded server (`cli.serve --sharded`, `shard_rows=True`) splits each
batch instead: rank 0 leads, and every `_step` it makes is one dispatch
over the ranks.  It broadcasts a header (run, rows, samples, mode, mask or
not), the batch padded with silent full-length filler rows to a multiple of
the ranks (JAX's `_pad_rows`) and its mask; each rank runs its block of
rows (`batch_sharding`) through the unchanged forward and reduction; the
blocks are gathered on rank 0, which drops the filler rows and returns what
one process returns.  The other ranks wait in `serve_follower` until the
leader broadcasts stop.  Everything goes over the control group as host
tensors: the batch arrives on the leader's host and the outputs leave from
it.  The leader's callers serialise every dispatch (the server's one device
lock), so the collectives go out in one order.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.processor import Wav2Vec2Processor
from .decoding import ctc_forced_align, ctc_prefix_beam_search, ctc_word_segments
from .models.modeling import default_compute_dtype, wav2vec2_for_ctc_forward
from .parallel import multihost
from .parallel.mesh import batch_sharding
from .utils.metrics import wer_details

# `_step`'s modes, by the index a dispatch header carries
STEP_MODES = ("argmax", "logprobs", "scored")
# what a dispatch header asks of the followers
_STOP, _RUN, _BEAT = 0, 1, 2


def default_buckets(max_len: int = 400000, num: int = 8) -> List[int]:
    """Bucket boundaries in waveform samples, multiples of 16000 (1 s),
    biased toward typical LibriSpeech utterance lengths."""
    edges = np.linspace(max_len / num, max_len, num)
    return [int(np.ceil(e / 16000) * 16000) for e in edges]


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
    """CTC inference for a `Wav2Vec2ForCTC` module, in its device's compute
    dtype (bf16 on the card, f32 on the CPU).  The robust family gets a
    sample mask; base checkpoints were trained without one.

    Device side: the forward, then the step mode's reduction of the f32
    logits (`_step`).  Host side: the CTC collapse (`Wav2Vec2Processor.decode`)
    or, with `beam_width > 0`, prefix beam search over the log-probs with
    optional shallow fusion of a `decoding.CharNGramLM` (`lm`, `lm_weight`,
    `token_bonus`); word timestamps and forced alignment from the frame path.
    """

    def __init__(
        self,
        model,
        *,
        beam_width: int = 0,
        lm=None,
        lm_weight: float = 0.5,
        token_bonus: float = 0.0,
        mesh=None,
        shard_rows: bool = False,
    ):
        if mesh is not None and mesh.model > 1:
            raise ValueError("the evaluator shards the corpus over the data axis only (model=1)")
        self.model = model
        self.mesh = mesh
        # the sharded server: rank 0's `_step` splits its rows over the ranks
        # (in one process there is nothing to split: the evaluator is local)
        self.shard_rows = shard_rows and self._multiprocess
        # the first collective failure of a dispatch: the group is broken and
        # every later dispatch raises; `on_peer_lost(exc)` is called with it
        self.peer_lost: Optional[BaseException] = None
        self.on_peer_lost = None
        self.config = model.config
        self.device = model.device
        self.compute_dtype = default_compute_dtype(self.device)
        self.tokenizer = Wav2Vec2Processor(is_tokenizer=True)
        self.use_attention_mask = self.config.is_robust
        self.beam_width = beam_width
        self.lm = lm
        self.lm_weight = lm_weight
        self.token_bonus = token_bonus

    # -- several processes ---------------------------------------------------

    @property
    def _multiprocess(self) -> bool:
        return self.mesh is not None and multihost.world_size() > 1

    def _lockstep(self, items, dummy):
        """Yield (item, is_real): one process passes `items` through; several
        all-gather a have-an-item flag each step (the control group), and a
        rank whose `items` ran dry yields `dummy()` until every rank's did."""
        if not self._multiprocess:
            for item in items:
                yield item, True
            return
        it = iter(items)
        while True:
            try:
                item, have = next(it), 1
            except StopIteration:
                item, have = None, 0
            if int(multihost.all_gather_ints([have]).max()) == 0:
                return
            yield (item if have else dummy()), bool(have)

    def _aggregate_wer(self, refs, hyps) -> Tuple[float, int]:
        """Corpus WER over every rank's shard: local (errors, words, n)
        counts, one all-gather, the exact global rate."""
        errors = words = 0
        for r, h in zip(refs, hyps):
            e, w = wer_details(r, h)
            errors += e
            words += w
        n = len(refs)
        if self._multiprocess:
            errors, words, n = (int(x) for x in multihost.sum_counts([errors, words, n]))
        if words == 0:
            raise ValueError("empty reference corpus")
        return errors / words, n

    def _step(self, speech: np.ndarray, mask: Optional[np.ndarray], mode: Optional[str] = None):
        """One forward on the model's device and one copy to the host.
        `mode`, computed on the device from the f32 logits:
          * "argmax"   — per-frame argmax ids (B, frames) int32 (greedy decode),
          * "logprobs" — the per-frame log-softmax (B, frames, vocab) f32
            (beam search, forced alignment),
          * "scored"   — (argmax ids, each frame's max log-prob (B, frames)
            f32): greedy decode with word timestamps and confidences.
        The default follows `beam_width`.  Returns host numpy (outs, frame
        lengths (B,) from the mask, or None without one).  On the sharded
        server's leader, one dispatch over every rank (`_lead_step`)."""
        if mode is None:
            mode = "logprobs" if self.beam_width > 0 else "argmax"
        if mode not in STEP_MODES:
            raise ValueError(f"unknown step mode {mode!r}")
        if self.shard_rows:
            return self._lead_step(speech, mask, mode)
        return self._local_step(speech, mask, mode)

    def _local_step(self, speech: np.ndarray, mask: Optional[np.ndarray], mode: str):
        """`_step` on this process's device alone."""
        with torch.inference_mode():
            x = torch.from_numpy(speech).to(self.device)
            m = None if mask is None else torch.from_numpy(mask).to(self.device)
            logits = wav2vec2_for_ctc_forward(
                self.model, self.config, x, m, compute_dtype=self.compute_dtype
            )
            if mode == "logprobs":
                outs = (torch.log_softmax(logits, dim=-1),)
            else:
                outs = (torch.argmax(logits, dim=-1).to(torch.int32),)
                if mode == "scored":
                    outs += (torch.log_softmax(logits, dim=-1).amax(dim=-1),)
            lengths = None
            if m is not None:
                lengths = self.config.conv_output_length(m.to(torch.int64).sum(dim=-1)).cpu().numpy()
            outs = tuple(o.cpu().numpy() for o in outs)
        return (outs if mode == "scored" else outs[0]), lengths

    # -- the sharded server ---------------------------------------------------

    def _header(self, op: int, rows: int = 0, samples: int = 0, mode: int = 0,
                has_mask: bool = False) -> None:
        """Broadcast a dispatch header from the leader."""
        multihost.broadcast_from_leader(
            torch.tensor([op, rows, samples, mode, int(has_mask)], dtype=torch.int64))

    def _collective(self, fn, *args):
        """`fn(*args)` on the leader; a failure marks the group as lost (every
        later dispatch raises at once) and reports it to `on_peer_lost`."""
        if self.peer_lost is not None:
            raise RuntimeError(f"a rank of the sharded server failed: {self.peer_lost}")
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 — any failure leaves the group unusable
            self.peer_lost = e
            if self.on_peer_lost is not None:
                self.on_peer_lost(e)
            raise

    def _lead_step(self, speech: np.ndarray, mask: Optional[np.ndarray], mode: str):
        """`_step` as one dispatch over the ranks: the rows padded with silent,
        full-length filler rows to a multiple of the ranks, broadcast with
        their mask, each rank's block through `_local_step`, the blocks
        gathered here and the filler rows dropped."""
        b, l = speech.shape
        pad = (-b) % multihost.world_size()
        speech = np.ascontiguousarray(speech, np.float32)
        if pad:
            speech = np.concatenate([speech, np.zeros((pad, l), np.float32)])
            if mask is not None:
                mask = np.concatenate([mask, np.ones((pad, l), mask.dtype)])

        def dispatch():
            self._header(_RUN, b + pad, l, STEP_MODES.index(mode), mask is not None)
            x = multihost.broadcast_from_leader(torch.from_numpy(speech))
            m = None
            if mask is not None:
                m = multihost.broadcast_from_leader(
                    torch.from_numpy(np.ascontiguousarray(mask, np.float32)))
            return self._block_step(x, m, mode)

        outs, lengths = self._collective(dispatch)
        outs = tuple(o[:b] for o in outs) if isinstance(outs, tuple) else outs[:b]
        return outs, (None if lengths is None else lengths[:b])

    def _block_step(self, speech: torch.Tensor, mask: Optional[torch.Tensor], mode: str):
        """This rank's block of the broadcast rows through `_local_step`; the
        blocks gathered on the leader in rank order.  Returns `_step`'s
        (outs, lengths) of every row on the leader, None elsewhere."""
        rows = batch_sharding(self.mesh, speech.shape[0])
        outs, lengths = self._local_step(speech[rows].numpy(),
                                         None if mask is None else mask[rows].numpy(), mode)
        parts = outs if isinstance(outs, tuple) else (outs,)
        if lengths is not None:
            parts += (np.asarray(lengths),)
        whole = [multihost.gather_to_leader(torch.from_numpy(np.ascontiguousarray(p)))
                 for p in parts]
        if multihost.rank() != 0:
            return None
        whole = [torch.cat(w).numpy() for w in whole]
        lengths = whole.pop() if lengths is not None else None
        return (tuple(whole) if mode == "scored" else whole[0]), lengths

    def heartbeat(self) -> None:
        """The leader's idle signal: a header that asks nothing, so that a
        follower's wait never reaches the group timeout while the server is
        idle, and a lost follower shows between requests."""
        self._collective(self._header, _BEAT)

    def stop_followers(self) -> None:
        """The leader's last dispatch: every follower leaves `serve_follower`."""
        self._collective(self._header, _STOP)

    def serve_follower(self) -> None:
        """A follower's loop (ranks >= 1 of the sharded server): wait for the
        leader's next header, run its block of each dispatch, return on stop.
        A failed collective (the leader lost, the group timeout) raises."""
        while True:
            op, rows, samples, mode, has_mask = multihost.broadcast_from_leader(
                torch.zeros(5, dtype=torch.int64)).tolist()
            if op == _STOP:
                return
            if op == _BEAT:
                continue
            x = multihost.broadcast_from_leader(torch.empty(rows, samples))
            m = multihost.broadcast_from_leader(torch.empty(rows, samples)) if has_mask else None
            self._block_step(x, m, STEP_MODES[mode])

    def _device_outputs(self, speech: np.ndarray, sample_lengths: np.ndarray, mode=None):
        """(outs, frame lengths clipped to [0, frames]) of `_step`:
        conv_output_length goes negative below ~25 samples on the 7-layer
        stack, and a negative slice bound would decode almost a full row."""
        l = speech.shape[1]
        mask = None
        if self.use_attention_mask:
            mask = (np.arange(l)[None, :] < sample_lengths[:, None]).astype(np.float32)
        outs, frame_lengths = self._step(speech, mask, mode)
        frames = (outs[0] if isinstance(outs, tuple) else outs).shape[1]
        if frame_lengths is None:
            # drop frames produced purely by padding
            frame_lengths = self.config.conv_output_length(sample_lengths)
        return outs, np.clip(np.asarray(frame_lengths), 0, frames)

    @staticmethod
    def _rows(speech: np.ndarray, sample_lengths: Optional[np.ndarray]):
        speech = np.ascontiguousarray(speech, np.float32)
        if sample_lengths is None:
            sample_lengths = np.full((speech.shape[0],), speech.shape[1], np.int64)
        return speech, np.asarray(sample_lengths, np.int64)

    def _beam_text(self, log_probs: np.ndarray) -> str:
        seq = ctc_prefix_beam_search(
            log_probs, self.beam_width, self.config.pad_id, lm=self.lm,
            lm_weight=self.lm_weight, token_bonus=self.token_bonus,
        )
        return self.tokenizer.decode(np.asarray(seq, np.int32), group_tokens=False)

    def _word_segments(self, ids, frame_probs):
        return ctc_word_segments(
            ids, frame_probs=frame_probs, pad_id=self.config.pad_id,
            delimiter_id=self.tokenizer.delimiter_id,
            id_to_token=self.tokenizer.id_to_token_mapping,
            frame_seconds=self.frame_seconds,
        )

    def _require_greedy(self) -> None:
        if self.beam_width > 0:
            raise ValueError(
                "word timestamps require greedy decoding (beam_width=0): "
                "beam search sums over alignments and keeps no frame path"
            )

    def predict_batch(
        self, speech: np.ndarray, sample_lengths: Optional[np.ndarray] = None
    ) -> List[str]:
        """speech: (B, L) normalised waveforms; sample_lengths: true lengths
        (defaults to L for all rows).  Greedy, or prefix beam search when
        `beam_width > 0`."""
        speech, sample_lengths = self._rows(speech, sample_lengths)
        outs, frame_lengths = self._device_outputs(speech, sample_lengths)
        if self.beam_width > 0:
            return [self._beam_text(outs[i, : frame_lengths[i]]) for i in range(len(outs))]
        return [self.tokenizer.decode(outs[i, : frame_lengths[i]]) for i in range(len(outs))]

    @property
    def frame_seconds(self) -> float:
        """Wall-clock seconds per encoder frame: the conv stack's total
        stride over the 16 kHz sample rate (20 ms for the standard
        [5,2,2,2,2,2,2] strides)."""
        return float(np.prod(self.config.strides)) / 16000.0

    def predict_segments(
        self, speech: np.ndarray, sample_lengths: Optional[np.ndarray] = None
    ):
        """Greedy decode with word-level timestamps and confidences: one
        `(text, words)` pair per row, `words` as `decoding.ctc_word_segments`
        gives them (start/end in seconds and frames, the mean per-frame
        probability of the argmax characters as a confidence; HuggingFace's
        `output_word_offsets` convention).  Greedy only."""
        self._require_greedy()
        speech, sample_lengths = self._rows(speech, sample_lengths)
        (ids, maxlogp), frame_lengths = self._device_outputs(speech, sample_lengths, "scored")
        return [
            self._word_segments(ids[i, : frame_lengths[i]], np.exp(maxlogp[i, : frame_lengths[i]]))
            for i in range(len(ids))
        ]

    def _windows(self, audio: np.ndarray, chunk_samples: int, context_samples: int, mode: str):
        """`_step` over the `plan_chunks` windows of `audio` (each padded to
        `chunk_samples`, masked for the robust family): the kept frames of
        each window, in order; they tile the utterance from frame 0."""
        plan = plan_chunks(
            len(audio), chunk_samples, context_samples,
            self.config.conv_output_length,
            total_stride=int(np.prod(self.config.strides)),
        )
        kept = []
        for start, keep_lo, keep_hi in plan:
            chunk = audio[start : start + chunk_samples]
            true_len = len(chunk)
            if true_len < chunk_samples:
                chunk = np.pad(chunk, (0, chunk_samples - true_len))
            mask = None
            if self.use_attention_mask:
                mask = (np.arange(chunk_samples) < true_len).astype(np.float32)[None, :]
            outs, _ = self._step(np.ascontiguousarray(chunk[None, :]), mask, mode)
            if isinstance(outs, tuple):
                kept.append(tuple(o[0, keep_lo:keep_hi] for o in outs))
            else:
                kept.append(outs[0, keep_lo:keep_hi])
        return kept

    def transcribe_long(
        self,
        audio: np.ndarray,
        chunk_samples: int = 246000,
        context_samples: int = 16000,
    ) -> str:
        """Transcribe audio of any length: windows of `chunk_samples` that
        overlap by `context_samples` on each side, each window's center
        frames kept (`plan_chunks`), one greedy collapse over the joined
        frame ids.  With `beam_width > 0`: one prefix beam search over the
        joined log-probs of the whole utterance."""
        audio = np.asarray(audio, np.float32)
        if len(audio) <= chunk_samples:
            return self.predict_batch(audio[None, :])[0]
        kept = np.concatenate(self._windows(audio, chunk_samples, context_samples, None), axis=0)
        if self.beam_width > 0:
            return self._beam_text(kept)
        return self.tokenizer.decode(kept)

    def transcribe_long_segments(
        self,
        audio: np.ndarray,
        chunk_samples: int = 246000,
        context_samples: int = 16000,
    ):
        """Long-form `predict_segments`: the windows of `transcribe_long`;
        the kept frames tile the utterance from frame 0, so word times stay
        global across window junctions."""
        self._require_greedy()
        audio = np.asarray(audio, np.float32)
        if len(audio) <= chunk_samples:
            return self.predict_segments(audio[None, :])[0]
        kept = self._windows(audio, chunk_samples, context_samples, "scored")
        return self._word_segments(
            np.concatenate([ids for ids, _ in kept]),
            np.exp(np.concatenate([logp for _, logp in kept])),
        )

    def align_segments(
        self,
        audio: np.ndarray,
        transcript: str,
        chunk_samples: int = 246000,
        context_samples: int = 16000,
        pad_to: Optional[int] = None,
    ):
        """Forced alignment: word timestamps for a known transcript.  The
        per-frame log-softmax comes from the device (long audio through the
        windows of `transcribe_long`, so frame indices are global), then
        `decoding.ctc_forced_align` finds the best CTC path that collapses
        to the transcript, segmented as `predict_segments` segments.

        Returns `(text, words)`: the normalised transcript and its words with
        start/end seconds, frames and a confidence (the mean per-frame
        probability of the aligned characters).  Raises ValueError if the
        transcript needs more frames than the audio has.

        `pad_to`: a single window is padded to this many samples first, so
        that a server aligns at its bucket shapes; the padding frames are
        cut before the trellis.  The robust family (masked) gives the
        unpadded result; for the base family the conv stack's GroupNorm
        sees the padding, so near-tie boundaries can move by a frame, as in
        the server's padded transcribe path."""
        label_ids = self.tokenizer(" ".join(transcript.split()))
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 1:
            raise ValueError(f"align_segments takes one utterance, got {audio.shape}")
        if len(audio) <= chunk_samples:
            true_len = len(audio)
            padded = audio
            if pad_to is not None and pad_to > true_len:
                padded = np.pad(audio, (0, pad_to - true_len))
            out, frame_lengths = self._device_outputs(
                np.ascontiguousarray(padded[None, :]), np.asarray([true_len], np.int64), "logprobs"
            )
            log_probs = out[0, : frame_lengths[0]]
        else:
            log_probs = np.concatenate(
                self._windows(audio, chunk_samples, context_samples, "logprobs"), axis=0
            )
        path, _ = ctc_forced_align(log_probs, label_ids, blank_id=self.config.pad_id)
        frame_probs = np.exp(log_probs[np.arange(len(path)), path].astype(np.float64))
        return self._word_segments(path, frame_probs)

    def evaluate_padded(
        self,
        samples: Iterable[Tuple[np.ndarray, str]],
        batch_size: int = 8,
        pad_to: int = 246000,
    ) -> Tuple[float, int]:
        """Reference constant-pad mode: every batch padded to `pad_to`
        samples, which is bucketed mode with one bucket.  `samples` yields
        (audio, reference text); returns (wer, num_samples), the global
        corpus's with several processes."""
        return self.evaluate_bucketed(samples, batch_size, [pad_to])

    def evaluate_bucketed(
        self,
        samples: Iterable[Tuple[np.ndarray, str]],
        batch_size: int = 8,
        buckets: Optional[Sequence[int]] = None,
    ) -> Tuple[float, int]:
        """Bucketed mode: each sample goes to the smallest bucket that holds
        it (the largest cuts longer audio), a bucket is run when it has
        `batch_size` samples, and the tails run at the end in bucket order:
        a handful of batch shapes, minimal padding.  Returns
        (wer, num_samples), the global corpus's with several processes."""
        buckets = sorted(default_buckets() if buckets is None else buckets)
        pending = defaultdict(list)  # bucket -> [(audio, text)]
        refs, hyps = [], []

        def flush(entries, bucket):
            """One forward over the entries' audio, zero-padded (or cut) to
            `bucket`; returns the transcripts."""
            speech = np.zeros((len(entries), bucket), np.float32)
            lengths = np.zeros((len(entries),), np.int64)
            for i, (audio, _) in enumerate(entries):
                lengths[i] = min(len(audio), bucket)
                speech[i, : lengths[i]] = audio[:bucket]
            return self.predict_batch(speech, lengths)

        def flushes():
            """(entries, bucket): full buckets as they fill, then the tails
            (each fewer than batch_size) in bucket order."""
            for audio, text in samples:
                bucket = next((b for b in buckets if len(audio) <= b), buckets[-1])
                pending[bucket].append((audio, text))
                if len(pending[bucket]) == batch_size:
                    yield pending.pop(bucket), bucket
            for bucket in sorted(pending):
                yield pending[bucket], bucket

        def dummy():  # one silent sample at the smallest bucket
            return [(np.zeros(buckets[0], np.float32), "")], buckets[0]

        for (entries, bucket), real in self._lockstep(flushes(), dummy):
            texts = flush(entries, bucket)
            if real:
                hyps.extend(texts)
                refs.extend(text for _, text in entries)
        return self._aggregate_wer(refs, hyps)
