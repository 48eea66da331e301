"""Incremental (streaming) transcription (a port of
`gsoc_wav2vec2_tpu/streaming.py`).

`evaluation.transcribe_long` lifts the length limit with overlapping
fixed-shape windows; this module makes that pipeline incremental: audio
arrives in pieces of any size (a microphone, a socket), each window is
transcribed as soon as its samples exist, and the committed transcript
grows monotonically.  `finish()` returns exactly the string
`transcribe_long` gives for the concatenated audio.

  * every window is one shape (`chunk_samples`), through the evaluator's
    `_step`;
  * windows overlap by `context_samples` on each side; only the center
    frames are committed (`plan_chunks` arithmetic, replayed
    incrementally with the same recurrence so junctions tile exactly);
  * the CTC collapse runs incrementally: each window's kept frames are
    collapsed against the previous window's final raw frame, so repeats
    across a boundary merge exactly like repeats inside a window and the
    committed text never retracts;
  * memory is O(chunk): consumed audio is dropped from the buffer.

Greedy only: beam search sums probability mass over alignments and admits
no frame-level commitment, so a stream would have to buffer everything,
which is `transcribe_long`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .decoding import segments_from_runs
from .evaluation import GreedyCTCEvaluator


class StreamingTranscriber:
    """Feed audio in pieces; read back a growing committed transcript.

    >>> ev = GreedyCTCEvaluator(model)
    >>> st = StreamingTranscriber(ev, chunk_samples=246000,
    ...                           context_samples=16000)
    >>> for piece in audio_pieces:
    ...     print(st.feed(piece))      # committed text so far
    >>> final = st.finish()            # == ev.transcribe_long(all_audio)

    One instance transcribes one utterance/stream; make a new instance per
    stream (the evaluator is shared).
    """

    def __init__(
        self,
        evaluator: GreedyCTCEvaluator,
        chunk_samples: int = 246000,
        context_samples: int = 16000,
        normalize_window: bool = False,
        word_timestamps: bool = False,
    ):
        if evaluator.beam_width > 0:
            raise ValueError(
                "streaming requires greedy decoding (beam_width=0): beam "
                "search keeps no frame-level commitment to stream"
            )
        if chunk_samples <= 2 * context_samples:
            raise ValueError(
                f"chunk {chunk_samples} must exceed 2x context "
                f"{context_samples}"
            )
        self.ev = evaluator
        self.chunk = int(chunk_samples)
        self.context = int(context_samples)
        # True: zero-mean/unit-variance each window over its REAL samples
        # (the processor's zscore, `data/processor.py::_normalize`, applied
        # per window) — for live sources where the full utterance's
        # statistics don't exist yet.  False (default): the caller feeds
        # already-normalized audio and `finish()` is bit-identical to the
        # offline `transcribe_long`.
        self.normalize_window = bool(normalize_window)
        # total stride of the conv stack: samples per output frame — the
        # frame grid every window start aligns to (`plan_chunks`)
        self.ts = int(np.prod(evaluator.config.strides))
        self.stride = self.chunk - 2 * self.context

        # True: windows run the "scored" program (argmax + per-frame max
        # prob) and committed runs carry global frame spans, so `words`
        # serves live word-level timestamps/confidences that grow with the
        # committed text (and `finish()`-time words equal the offline
        # `transcribe_long_segments` exactly, modulo float addition order
        # in the confidences)
        self.word_timestamps = bool(word_timestamps)

        self._buf = np.zeros((0,), np.float32)
        self._off = 0  # absolute sample index of _buf[0]
        self._total = 0  # absolute samples fed so far
        # plan recurrence state (mirrors evaluation.plan_chunks exactly)
        self._start = 0  # next center-region start (samples)
        self._prev_boundary = 0  # global frame where the last window stopped
        self._windows = 0
        # incremental CTC collapse state
        self._tokens: List[int] = []  # committed, collapsed, pad-free ids
        self._prev_raw_last: Optional[int] = None
        self._final_text: Optional[str] = None
        # committed non-pad runs: [id, gstart, gend, prob_sum] in global
        # frames (word_timestamps mode only)
        self._runs: List[list] = []
        self._final_words: Optional[list] = None

    # -- public surface ----------------------------------------------------

    @property
    def finished(self) -> bool:
        return self._final_text is not None

    @property
    def text(self) -> str:
        """Committed transcript so far (final text once `finish()` ran)."""
        if self._final_text is not None:
            return self._final_text
        if not self._tokens:
            return ""
        return self.ev.tokenizer.decode(
            np.asarray(self._tokens, np.int32), group_tokens=False
        )

    @property
    def samples_fed(self) -> int:
        return self._total

    @property
    def words(self) -> list:
        """Committed word segments so far (word_timestamps mode): dicts
        with word/start/end/frames/confidence, global times in seconds —
        grows monotonically with `text`; after `finish()` it equals the
        offline `transcribe_long_segments` words."""
        if not self.word_timestamps:
            raise ValueError(
                "construct StreamingTranscriber(word_timestamps=True) "
                "to stream word segments"
            )
        if self._final_words is not None:
            return self._final_words
        _, words = segments_from_runs(
            [tuple(r) for r in self._runs],
            pad_id=self.ev.config.pad_id,
            delimiter_id=self.ev.tokenizer.delimiter_id,
            id_to_token=self.ev.tokenizer.id_to_token_mapping,
            frame_seconds=self.ev.frame_seconds,
            with_probs=True,
        )
        return words

    def feed(self, samples: np.ndarray) -> str:
        """Append audio; transcribe every window whose samples now exist.
        Returns the committed transcript so far."""
        if self.finished:
            raise ValueError("stream already finished")
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            self._buf = np.concatenate([self._buf, samples])
            self._total += samples.size
        self._drain(total_len=None)
        return self.text

    def finish(self) -> str:
        """Flush the tail windows and return the final transcript —
        identical to `transcribe_long` over the whole audio."""
        if self.finished:
            return self._final_text
        if self._windows == 0 and self._total <= self.chunk:
            # short-audio path: one unpadded exact-shape decode, matching
            # transcribe_long's `len(audio) <= chunk_samples` branch
            audio = self._buf[: self._total]
            if self.normalize_window and self._total:
                audio = (audio - audio.mean()) / np.sqrt(audio.var() + 1e-5)
            if not self._total:
                text, self._final_words = "", []
            elif self.word_timestamps:
                text, self._final_words = self.ev.predict_segments(
                    audio[None, :]
                )[0]
            else:
                text = self.ev.predict_batch(audio[None, :])[0]
        else:
            self._drain(total_len=self._total)
            text = self.text
        self._final_text = text
        self._buf = np.zeros((0,), np.float32)
        return text

    # -- internals -----------------------------------------------------------

    def _drain(self, total_len: Optional[int]) -> None:
        """Process ready windows.  `total_len=None` (mid-stream): only
        windows whose FULL `chunk` samples exist — such a window cannot be
        the plan's final one, so its keep range needs no total length.
        `total_len=N` (finish): replay the remainder of the plan_chunks
        recurrence verbatim, including the final window's
        conv_output_length end."""
        f = lambda n: int(self.ev.config.conv_output_length(int(n)))
        while True:
            known_total = total_len if total_len is not None else self._total
            if self._start >= known_total:
                return
            win_start = max(0, self._start - self.context)
            win_start -= win_start % self.ts  # align to the frame grid
            if total_len is None and self._total < win_start + self.chunk:
                return  # need more samples before this window is non-final
            base_frame = win_start // self.ts
            center_end = min(self._start + self.stride, known_total)
            keep_lo = self._prev_boundary - base_frame
            if center_end < known_total or total_len is None:
                keep_hi = min(
                    center_end // self.ts - base_frame, f(self.chunk)
                )
            else:
                keep_hi = f(min(total_len - win_start, self.chunk))
            if keep_hi > keep_lo:
                ids, probs = self._window_ids(win_start)
                self._commit(
                    ids[keep_lo:keep_hi],
                    None if probs is None else probs[keep_lo:keep_hi],
                    base_frame + keep_lo,
                )
                self._prev_boundary = base_frame + keep_hi
                self._windows += 1
            self._start = center_end
            # drop consumed audio: nothing before the NEXT window's
            # (aligned) start is ever read again
            nxt = max(0, self._start - self.context)
            nxt -= nxt % self.ts
            if nxt > self._off:
                self._buf = self._buf[nxt - self._off :]
                self._off = nxt

    def _window_ids(self, win_start: int):
        """Per-frame argmax ids (and, in word_timestamps mode, per-frame
        argmax probabilities) for the window at `win_start`: the evaluator's
        `_step` with the padding and mask of `transcribe_long`."""
        lo = win_start - self._off
        if lo < 0:
            raise RuntimeError("window start was trimmed from the buffer")
        chunk = self._buf[lo : lo + self.chunk]
        true_len = len(chunk)
        if self.normalize_window and true_len:
            chunk = (chunk - chunk.mean()) / np.sqrt(chunk.var() + 1e-5)
        if true_len < self.chunk:
            chunk = np.pad(chunk, (0, self.chunk - true_len))
        ev = self.ev
        mask = None
        if ev.use_attention_mask:
            mask = (np.arange(self.chunk) < true_len).astype(np.float32)[None, :]
        mode = "scored" if self.word_timestamps else "argmax"
        preds, _ = ev._step(np.ascontiguousarray(chunk[None, :], np.float32), mask, mode)
        if self.word_timestamps:
            ids, maxlogp = preds
            return ids[0], np.exp(maxlogp[0])
        return preds[0], None

    def _commit(self, ids: np.ndarray, probs, gbase: int) -> None:
        """Incremental greedy-CTC collapse: unique-consecutive within the
        new frames, merged against the previous window's last raw frame,
        pads dropped — byte-identical to collapsing the concatenated
        stream in one pass.  `gbase` is the global frame index of
        `ids[0]`; in word_timestamps mode the committed runs also carry
        global frame spans + probability sums (frames are contiguous
        across commits, so a run continuing over a window boundary merges
        exactly when its id matches and its span is adjacent)."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        keep = np.ones(len(ids), bool)
        keep[1:] = ids[1:] != ids[:-1]
        collapsed = ids[keep]
        boundary_merge = (
            self._prev_raw_last is not None
            and collapsed.size
            and int(collapsed[0]) == self._prev_raw_last
        )
        self._prev_raw_last = int(ids[-1])
        pad = self.ev.config.pad_id
        self._tokens.extend(
            int(t)
            for t in (collapsed[1:] if boundary_merge else collapsed)
            if int(t) != pad
        )
        if not self.word_timestamps:
            return
        starts = np.flatnonzero(keep)
        ends = np.append(starts[1:], len(ids))
        for fid, s, e in zip(collapsed, starts, ends):
            fid = int(fid)
            if fid == pad:
                continue
            gstart, gend = gbase + int(s), gbase + int(e)
            psum = float(np.sum(probs[s:e]))
            if self._runs and self._runs[-1][0] == fid and \
                    self._runs[-1][2] == gstart:
                self._runs[-1][2] = gend
                self._runs[-1][3] += psum
            else:
                self._runs.append([fid, gstart, gend, psum])
