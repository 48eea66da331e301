"""CTC decoding beyond greedy: prefix beam search, a character n-gram LM
for shallow fusion, forced alignment and word segments (a copy of
`gsoc_wav2vec2_tpu/decoding.py`: the same math, the same engine switch and
the same LM file format, so an LM saved by either package loads in the
other).

Greedy decoding picks the best *frame path*, not the best *label
sequence*; prefix beam search (Hannun et al., 2014, arXiv:1408.2873) sums
alignment mass per prefix.

Host-side numpy by design: the per-frame state is a ragged
prefix->probability map (data-dependent control flow), while the heavy
part, the log-softmax over frames, stays on the device
(`evaluation.GreedyCTCEvaluator`'s "logprobs" mode).
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Tuple

import numpy as np

NEG_INF = -np.inf


class CharNGramLM:
    """Witten-Bell-interpolated character n-gram LM over tokenizer ids.

    The wav2vec2 paper's own evaluation decodes with an external language
    model fused into beam search (arXiv:2006.11477 §4).  This is a
    dependency-free stand-in: train
    it on the fine-tuning corpus transcripts (`fit`), persist as JSON, and
    pass to `ctc_prefix_beam_search(lm=..., lm_weight=...)` for shallow
    fusion.

    Witten-Bell:  P(s|ctx) = (c(ctx·s) + T(ctx)·P(s|ctx[1:])) / (c(ctx) + T(ctx))
    with T(ctx) = #distinct continuations of ctx; base case is uniform over
    the vocab.  Parameter-free, properly normalised, never zero.
    """

    def __init__(self, order: int = 4, vocab_size: int = 32):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.order = order
        self.vocab_size = vocab_size
        # counts[k][ctx_tuple] = {next_id: count}; ctx length k in [0, order-1]
        self.counts: List[dict] = [dict() for _ in range(order)]

    def fit(self, id_sequences: Iterable[List[int]]) -> "CharNGramLM":
        for seq in id_sequences:
            seq = list(seq)
            for i, s in enumerate(seq):
                for k in range(self.order):
                    if i < k:
                        continue
                    ctx = tuple(seq[i - k:i])
                    bucket = self.counts[k].setdefault(ctx, {})
                    bucket[s] = bucket.get(s, 0) + 1
        return self

    def _prob(self, ctx: Tuple[int, ...], s: int) -> float:
        if not ctx:
            bucket = self.counts[0].get((), {})
            total = sum(bucket.values())
            distinct = len(bucket)
            base = 1.0 / self.vocab_size
            if total == 0:
                return base
            return (bucket.get(s, 0) + distinct * base) / (total + distinct)
        bucket = self.counts[len(ctx)].get(ctx, {})
        lower = self._prob(ctx[1:], s)
        total = sum(bucket.values())
        distinct = len(bucket)
        if total == 0:
            return lower
        return (bucket.get(s, 0) + distinct * lower) / (total + distinct)

    def logp(self, context: Tuple[int, ...], s: int) -> float:
        """log P(s | last `order-1` ids of `context`)."""
        ctx = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        return float(np.log(self._prob(ctx, s)))

    def save(self, path: str) -> None:
        payload = {
            "order": self.order,
            "vocab_size": self.vocab_size,
            "counts": [
                {",".join(map(str, ctx)): bucket for ctx, bucket in level.items()}
                for level in self.counts
            ],
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    @classmethod
    def fit_from_librispeech(
        cls, data_dir: str, order: int = 4, vocab_size: int = 32
    ) -> "CharNGramLM":
        """Fit on every `*.trans.txt` transcript under a LibriSpeech-layout
        corpus (the same files the loaders read, `data/loaders.py`)."""
        import os

        from .data.processor import Wav2Vec2Processor

        tokenizer = Wav2Vec2Processor(is_tokenizer=True)
        lm = cls(order, vocab_size)

        def texts():
            for root, _dirs, files in os.walk(data_dir):
                for name in sorted(files):
                    if not name.endswith(".trans.txt"):
                        continue
                    with open(os.path.join(root, name)) as f:
                        for line in f:
                            _utt, _, text = line.strip().partition(" ")
                            if text:
                                yield tokenizer(text)

        return lm.fit(texts())

    @classmethod
    def load(cls, path: str) -> "CharNGramLM":
        with open(path) as f:
            payload = json.load(f)
        lm = cls(payload["order"], payload["vocab_size"])
        lm.counts = [
            {
                tuple(int(x) for x in ctx.split(",") if ctx): {
                    int(s): c for s, c in bucket.items()
                }
                for ctx, bucket in level.items()
            }
            for level in payload["counts"]
        ]
        return lm


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    return float(np.logaddexp(a, b))


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 25,
    blank_id: int = 0,
    top_k_tokens: int = 0,
    lm: Optional[CharNGramLM] = None,
    lm_weight: float = 0.5,
    token_bonus: float = 0.0,
) -> List[int]:
    """Most probable label sequence under the CTC alignment-sum criterion.

    Args:
      log_probs: (T, V) per-frame log-probabilities (log-softmax outputs).
      beam_width: number of prefixes kept per frame.
      blank_id: CTC blank (== pad, id 0 for this vocab — reference
        `losses.py:41`).
      top_k_tokens: per-frame vocabulary pruning (0 = no pruning); with
        vocab 32 the exact sweep is cheap, so pruning is off by default.
      lm / lm_weight / token_bonus: shallow fusion — every prefix
        EXTENSION adds `lm_weight * log P_lm(s | prefix) + token_bonus`
        to the beam score (the bonus counteracts the LM's per-token
        penalty, the classic insertion-bonus trick).
    Returns the winning prefix as a list of token ids (already collapsed —
    no repeats, no blanks).

    Without an LM the numpy-vectorized engine runs (about 20x the
    per-frame dict version); LM fusion needs per-prefix context lookups
    and takes the dict path.
    """
    if lm is None:
        return _beam_search_vectorized(
            np.asarray(log_probs, np.float64), beam_width, blank_id,
            top_k_tokens,
        )
    log_probs = np.asarray(log_probs, np.float64)
    t_len, vocab = log_probs.shape
    # prefix -> (log P(prefix, ends in blank), log P(prefix, ends in token))
    beams: dict = {(): (0.0, NEG_INF)}
    lm_cache: dict = {}

    def lm_bonus(prefix, s) -> float:
        if lm is None:
            return 0.0
        key = (prefix[-(lm.order - 1):] if lm.order > 1 else (), s)
        got = lm_cache.get(key)
        if got is None:
            got = lm_weight * lm.logp(key[0], s) + token_bonus
            lm_cache[key] = got
        return got

    for t in range(t_len):
        frame = log_probs[t]
        if top_k_tokens and top_k_tokens < vocab:
            tokens = np.argpartition(-frame, top_k_tokens)[:top_k_tokens]
        else:
            tokens = range(vocab)
        new: dict = {}

        def accumulate(prefix, pb, pnb):
            old_pb, old_pnb = new.get(prefix, (NEG_INF, NEG_INF))
            new[prefix] = (_logaddexp(old_pb, pb), _logaddexp(old_pnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = _logaddexp(pb, pnb)
            for s in tokens:
                p_s = float(frame[s])
                if s == blank_id:
                    # blank extends the SAME prefix, ending in blank
                    accumulate(prefix, total + p_s, NEG_INF)
                elif prefix and prefix[-1] == s:
                    # repeated token: without an intervening blank it
                    # collapses into the same prefix; with one (pb) it
                    # starts a new occurrence
                    accumulate(prefix, NEG_INF, pnb + p_s)
                    accumulate(
                        prefix + (s,), NEG_INF,
                        pb + p_s + lm_bonus(prefix, s),
                    )
                else:
                    accumulate(
                        prefix + (s,), NEG_INF,
                        total + p_s + lm_bonus(prefix, s),
                    )

        ranked = sorted(
            new.items(), key=lambda kv: _logaddexp(*kv[1]), reverse=True
        )
        beams = dict(ranked[:beam_width])

    best = max(beams.items(), key=lambda kv: _logaddexp(*kv[1]))
    return list(best[0])


_FNV_OFFSET = np.uint64(1469598103934665603)
_FNV_PRIME = np.uint64(1099511628211)


def _beam_search_vectorized(
    log_probs: np.ndarray,
    beam_width: int,
    blank_id: int,
    top_k_tokens: int,
) -> List[int]:
    """Array-engine prefix beam search (no LM): all K x V candidate
    extensions of a frame are generated, duplicate prefixes merged and the
    top K selected with numpy, so Python touches only the K survivors per
    frame.

    Prefix identity is a 64-bit FNV-style rolling hash
    (h' = h * P + token + 1): two candidates merge iff their label
    sequences match.  A spurious 64-bit collision would need ~2^32 live
    prefixes (birthday bound) vs the ~K*V = 800 alive here — not a
    practical concern.  Semantics are pinned to the dict engine by
    `test_vectorized_matches_dict_engine` and the brute-force oracle.
    """
    t_len, vocab = log_probs.shape
    if t_len == 0:
        return []

    # per-beam state; beams[0] is the empty prefix
    pb = np.full(1, 0.0)  # log P(prefix, ends in blank)
    pnb = np.full(1, NEG_INF)  # log P(prefix, ends in non-blank)
    last = np.full(1, -1, np.int64)  # last token id (-1: empty)
    hashes = np.array([_FNV_OFFSET], np.uint64)
    prefixes: List[tuple] = [()]

    tokens_all = np.arange(vocab)
    with np.errstate(invalid="ignore"):  # -inf + -inf etc. are expected
        for t in range(t_len):
            frame = log_probs[t].copy()
            if top_k_tokens and top_k_tokens < vocab:
                # pruned tokens contribute nothing (matches the dict
                # engine, which never iterates them)
                drop = np.argpartition(-frame, top_k_tokens)[top_k_tokens:]
                frame[drop] = NEG_INF
            k = len(pb)
            total = np.logaddexp(pb, pnb)

            # class A: the SAME prefix survives via blank ...
            a_pb = total + frame[blank_id]
            # ... or via a repeat of its last token without a blank gap
            rep = np.where(last >= 0, frame[np.maximum(last, 0)], NEG_INF)
            a_pnb = pnb + rep

            # class B: extend every beam with every non-blank token s;
            # a repeat (s == last) can only follow a blank-ending path
            ext = np.where(
                tokens_all[None, :] == last[:, None], pb[:, None],
                total[:, None],
            ) + frame[None, :]  # (K, V)
            ext[:, blank_id] = NEG_INF
            ext_hash = hashes[:, None] * _FNV_PRIME + (
                tokens_all[None, :].astype(np.uint64) + np.uint64(1)
            )

            # merge by prefix identity: A keeps its hash, B gets child's
            cand_hash = np.concatenate([hashes, ext_hash.reshape(-1)])
            cand_pb = np.concatenate([a_pb, np.full(k * vocab, NEG_INF)])
            cand_pnb = np.concatenate([a_pnb, ext.reshape(-1)])
            order = np.argsort(cand_hash, kind="stable")
            h_sorted = cand_hash[order]
            starts = np.flatnonzero(
                np.concatenate([[True], h_sorted[1:] != h_sorted[:-1]])
            )
            g_pb = np.logaddexp.reduceat(cand_pb[order], starts)
            g_pnb = np.logaddexp.reduceat(cand_pnb[order], starts)
            g_first = order[starts]  # representative candidate per group

            g_total = np.logaddexp(g_pb, g_pnb)
            top = np.argsort(-g_total, kind="stable")[:beam_width]

            new_prefixes = []
            new_last = np.empty(len(top), np.int64)
            for i, g in enumerate(top):
                rep_idx = g_first[g]
                if rep_idx < k:  # class A: existing prefix
                    new_prefixes.append(prefixes[rep_idx])
                    new_last[i] = last[rep_idx]
                else:  # class B: parent k, token s
                    parent, s = divmod(rep_idx - k, vocab)
                    new_prefixes.append(prefixes[parent] + (int(s),))
                    new_last[i] = s
            pb, pnb = g_pb[top], g_pnb[top]
            hashes = h_sorted[starts][top]
            last = new_last
            prefixes = new_prefixes

    best = int(np.argmax(np.logaddexp(pb, pnb)))
    return list(prefixes[best])


def ctc_beam_decode_batch(
    log_probs: np.ndarray,
    lengths: np.ndarray,
    beam_width: int = 25,
    blank_id: int = 0,
    lm: Optional[CharNGramLM] = None,
    lm_weight: float = 0.5,
    token_bonus: float = 0.0,
) -> List[List[int]]:
    """Beam-decode a padded batch: (B, T, V) + per-row frame lengths."""
    return [
        ctc_prefix_beam_search(
            log_probs[i, : int(lengths[i])], beam_width, blank_id,
            lm=lm, lm_weight=lm_weight, token_bonus=token_bonus,
        )
        for i in range(log_probs.shape[0])
    ]


def brute_force_ctc_best(
    log_probs: np.ndarray, blank_id: int = 0
) -> Tuple[List[int], float]:
    """Exact best label sequence by enumerating ALL V^T alignment paths —
    exponential, test-oracle only."""
    log_probs = np.asarray(log_probs, np.float64)
    t_len, vocab = log_probs.shape
    totals: dict = {}
    paths = [((), 0.0)]
    for t in range(t_len):
        nxt = []
        for path, lp in paths:
            for s in range(vocab):
                nxt.append((path + (s,), lp + float(log_probs[t, s])))
        paths = nxt
    for path, lp in paths:
        collapsed = []
        prev = None
        for s in path:
            if s != blank_id and s != prev:
                collapsed.append(s)
            prev = s
        key = tuple(collapsed)
        totals[key] = _logaddexp(totals.get(key, NEG_INF), lp)
    best = max(totals.items(), key=lambda kv: kv[1])
    return list(best[0]), best[1]


def ctc_forced_align(
    log_probs: np.ndarray,
    label_ids,
    *,
    blank_id: int = 0,
) -> Tuple[np.ndarray, float]:
    """Viterbi forced alignment of a KNOWN transcript over the CTC trellis.

    Greedy decode (`ctc_word_segments`) times whatever the model *thinks*
    was said; forced alignment times what was *actually* said — the classic
    wav2vec2 application (subtitle/karaoke alignment).  Standard CTC trellis (Graves et al., 2006): the label
    sequence is interleaved with blanks into states
    ``[blank, l1, blank, l2, …, blank]``; transitions are stay, advance by
    one, or skip a blank (only between distinct consecutive labels); the
    max-probability path is recovered by backtracking.

    Args:
      log_probs: (T, V) per-frame log-probabilities (log-softmax output).
      label_ids: the transcript as tokenizer ids, WITHOUT blanks.
      blank_id: CTC blank (== pad, reference `losses.py:41`).

    Returns ``(frame_path, score)``: `frame_path[t]` is the symbol emitted
    at frame t (`blank_id` for blanks) — collapsing it yields exactly
    `label_ids` — and `score` is the path log-probability.  Raises
    ValueError if the transcript cannot fit in T frames (CTC needs one
    frame per label plus a blank between repeated labels).

    Memory is O(T·S) int8 backpointers (S = 2·len(labels)+1): ~20 MB for a
    3-minute utterance with a 1000-char transcript; align hour-long audio
    in chapters.
    """
    log_probs = np.asarray(log_probs, np.float64)
    if log_probs.ndim != 2:
        raise ValueError(f"log_probs must be (T, V), got {log_probs.shape}")
    t_len, vocab = log_probs.shape
    labels = [int(s) for s in np.asarray(label_ids).reshape(-1)]
    if any(s == blank_id for s in labels):
        raise ValueError("label_ids must not contain the blank id")
    if any(not 0 <= s < vocab for s in labels):
        raise ValueError(f"label id out of range [0, {vocab})")
    if t_len == 0:
        raise ValueError("empty log_probs")
    if not labels:
        return (
            np.full((t_len,), blank_id, np.int32),
            float(log_probs[:, blank_id].sum()),
        )

    n = len(labels)
    s_len = 2 * n + 1
    ext = np.full((s_len,), blank_id, np.int64)
    ext[1::2] = labels
    # skip (s-2 → s) is legal only into a label state whose label differs
    # from the previous label (identical neighbours REQUIRE the blank)
    can_skip = np.zeros((s_len,), bool)
    can_skip[3::2] = ext[3::2] != ext[1:-2:2]

    dp = np.full((s_len,), NEG_INF)
    dp[0] = log_probs[0, blank_id]
    dp[1] = log_probs[0, ext[1]]
    # back[t, s] ∈ {0: stay, 1: from s-1, 2: from s-2}
    back = np.zeros((t_len, s_len), np.int8)
    pad2 = np.full((2,), NEG_INF)
    for t in range(1, t_len):
        stay = dp
        step = np.concatenate((pad2[:1], dp[:-1]))
        skip = np.where(can_skip, np.concatenate((pad2, dp[:-2])), NEG_INF)
        stacked = np.stack((stay, step, skip))
        back[t] = np.argmax(stacked, axis=0)
        dp = stacked.max(axis=0) + log_probs[t, ext]

    score = float(max(dp[-1], dp[-2]))
    if score == NEG_INF:
        raise ValueError(
            f"transcript needs more frames than available: {n} labels "
            f"(+ blanks between repeats) cannot align to {t_len} frames"
        )
    s = s_len - 1 if dp[-1] >= dp[-2] else s_len - 2
    path = np.empty((t_len,), np.int32)
    for t in range(t_len - 1, 0, -1):
        path[t] = ext[s]
        s -= int(back[t, s])  # keep s a Python int (int8 would overflow)
    path[0] = ext[s]
    return path, score


def ctc_word_segments(
    frame_ids,
    *,
    pad_id: int,
    delimiter_id: int,
    id_to_token: dict,
    frame_seconds: float,
    frame_probs=None,
):
    """Word-level segments from a greedy CTC frame path.

    The reference decodes to a bare string (`processor.py:71-89`); serving
    users also want WHERE each word was said.  Greedy argmax keeps the
    frame alignment that beam search integrates away, so word boundaries
    fall out of the run structure: collapse `frame_ids` into runs, give
    each non-blank run its `[start_frame, end_frame)` span, and group
    char runs into words at delimiter runs.  The offset convention matches
    HuggingFace's `Wav2Vec2CTCTokenizer.decode(output_word_offsets=True)`
    exactly: a char repeated
    over frames 5,6,7 spans [5, 8); a word spans from its first char's
    start to its last char's end; blank frames between chars of a word are
    inside the word's span but carry no char.

    `frame_probs` (optional): per-frame probability of the argmax symbol.
    Each word then gets a `confidence` — the mean probability over the
    frames of its char runs (blank frames excluded: the model asserted
    no symbol there).

    Returns `(text, words)`.  `text` is the exact greedy transcription
    (join of char runs, delimiter -> space); `words` is a list of dicts
    `{"word", "start", "end", "start_frame", "end_frame"[, "confidence"]}`
    with times in seconds (`offset * frame_seconds`, the conv stack's
    total stride over the sample rate).
    """
    frame_ids = [int(i) for i in frame_ids]
    # run-length collapse with positions: (id, start_frame, end_frame)
    runs = []
    for i, fid in enumerate(frame_ids):
        if runs and runs[-1][0] == fid:
            runs[-1][2] = i + 1
        else:
            runs.append([fid, i, i + 1])
    if frame_probs is not None:
        runs = [
            (fid, start, end, float(np.sum(frame_probs[start:end])))
            for fid, start, end in runs
        ]
    return segments_from_runs(
        runs,
        pad_id=pad_id,
        delimiter_id=delimiter_id,
        id_to_token=id_to_token,
        frame_seconds=frame_seconds,
        with_probs=frame_probs is not None,
    )


def segments_from_runs(
    runs,
    *,
    pad_id: int,
    delimiter_id: int,
    id_to_token: dict,
    frame_seconds: float,
    with_probs: bool = False,
):
    """(text, words) from run-length-collapsed frames.

    `runs`: `(id, start_frame, end_frame[, prob_sum])` tuples in frame
    order — the shared core of `ctc_word_segments` (offline frame paths)
    and `streaming.StreamingTranscriber` (incrementally committed runs).
    `prob_sum` is the summed per-frame probability over the run's frames
    (only read when `with_probs`).
    """
    words = []
    text_parts: List[str] = []
    cur_chars: List[str] = []
    cur_start = cur_end = 0
    cur_prob_sum, cur_prob_frames = 0.0, 0

    def flush_word():
        nonlocal cur_chars, cur_prob_sum, cur_prob_frames
        if cur_chars:
            entry = {
                "word": "".join(cur_chars),
                # exact multiples of frame_seconds — callers round for
                # display (a frame is 0.625 ms on the tiny test stack)
                "start": cur_start * frame_seconds,
                "end": cur_end * frame_seconds,
                "start_frame": cur_start,
                "end_frame": cur_end,
            }
            if with_probs and cur_prob_frames:
                entry["confidence"] = round(cur_prob_sum / cur_prob_frames, 4)
            words.append(entry)
        cur_chars = []
        cur_prob_sum, cur_prob_frames = 0.0, 0

    for run in runs:
        fid, start, end = run[0], run[1], run[2]
        if fid == pad_id:
            continue  # blank: no symbol, no state change
        if fid == delimiter_id:
            flush_word()
            text_parts.append(" ")
            continue
        token = id_to_token.get(fid, "<unk>")
        if not cur_chars:
            cur_start = start
        cur_end = end
        cur_chars.append(token)
        text_parts.append(token)
        if with_probs:
            cur_prob_sum += float(run[3])
            cur_prob_frames += end - start
    flush_word()
    return "".join(text_parts).strip(), words
