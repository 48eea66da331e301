"""The port's `decoding.py` against the JAX package's on the same seeded
inputs: prefix beam search (the vectorised engine and the dict engine, widths
1, 4 and 16, with and without LM fusion), the brute-force oracle,
`CharNGramLM` (fit, logp, `fit_from_librispeech`, JSON save / load in both
directions), `ctc_forced_align`, `ctc_word_segments` and `segments_from_runs`.
Ids, strings and frames must be equal, scores within 1e-9 (the same numpy),
plus ports of the cases of `tests/test_beam_decode.py` and
`tests/test_forced_align.py` that need no model."""

import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu import decoding as jd
from gsoc_wav2vec2_tpu_torch import decoding as pd
from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor

torch.set_num_threads(2)
TOKENIZER = Wav2Vec2Processor(is_tokenizer=True)


def _log_probs(t, v, seed, sharp=1.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, v)) * sharp
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def _lm_pair(order=3, vocab=8, seed=0, n=30):
    rng = np.random.default_rng(seed)
    seqs = [[int(s) for s in rng.integers(1, vocab, size=int(rng.integers(2, 12)))]
            for _ in range(n)]
    return pd.CharNGramLM(order, vocab).fit(seqs), jd.CharNGramLM(order, vocab).fit(seqs)


@pytest.mark.parametrize("width", [1, 4, 16])
@pytest.mark.parametrize("fused", [False, True])
def test_beam_search_matches_jax(width, fused):
    """Both engines (no LM: the vectorised one; an LM: the dict one), with
    and without per-frame pruning, on random frames: the same ids."""
    lm, jlm = _lm_pair() if fused else (None, None)
    for seed in range(6):
        for t, v, topk in [(20, 8, 0), (120, 8, 4), (300, 8, 0)]:
            lp = _log_probs(t, v, seed)
            kw = dict(top_k_tokens=topk, lm_weight=0.7, token_bonus=0.3)
            got = pd.ctc_prefix_beam_search(lp, width, lm=lm, **kw)
            want = jd.ctc_prefix_beam_search(lp, width, lm=jlm, **kw)
            assert got == want, (seed, t, topk)


@pytest.mark.parametrize("width", [1, 4, 16])
def test_dict_engine_matches_vectorised_engine(width):
    """An LM at weight 0 takes the dict engine without moving any score."""
    null_lm = pd.CharNGramLM(order=1, vocab_size=8)
    for seed in range(5):
        for t, topk in [(50, 0), (768, 0), (120, 4)]:
            lp = _log_probs(t, 8, seed)
            assert pd.ctc_prefix_beam_search(lp, width, top_k_tokens=topk) == \
                pd.ctc_prefix_beam_search(lp, width, top_k_tokens=topk, lm=null_lm, lm_weight=0.0)


def test_beam_decode_batch_matches_jax():
    lp = np.stack([_log_probs(40, 32, s) for s in range(3)]).astype(np.float32)
    lengths = np.array([40, 17, 0])
    lm, jlm = _lm_pair(vocab=32)
    for kw in (dict(), dict(lm=lm, lm_weight=0.4)):
        jkw = dict(kw, lm=jlm) if kw else kw
        got = pd.ctc_beam_decode_batch(lp, lengths, 4, **kw)
        assert got == jd.ctc_beam_decode_batch(lp, lengths, 4, **jkw)
        assert got[2] == []


def test_brute_force_oracle_matches_jax_and_beam():
    for seed in range(8):
        lp = _log_probs(5, 4, seed)
        ids, score = pd.brute_force_ctc_best(lp)
        want_ids, want_score = jd.brute_force_ctc_best(lp)
        assert ids == want_ids and abs(score - want_score) <= 1e-9
        # a wide beam finds the max-alignment-mass label sequence
        assert pd.ctc_prefix_beam_search(lp, beam_width=64) == ids


def test_beam_beats_greedy_on_split_mass_and_sharp_frames_agree():
    p = np.log(np.asarray([[0.6, 0.4], [0.6, 0.4]]))
    assert pd.ctc_prefix_beam_search(p, beam_width=4) == [1]  # greedy: empty
    lp = _log_probs(12, 6, 3, sharp=20.0)
    path = np.argmax(lp, axis=-1)
    collapsed = [int(s) for i, s in enumerate(path) if s != 0 and (i == 0 or s != path[i - 1])]
    assert pd.ctc_prefix_beam_search(lp, beam_width=8) == collapsed


def test_shallow_fusion_recovers_ambiguous_token():
    lm = pd.CharNGramLM(order=2, vocab_size=4).fit([[1, 2]] * 20)
    p = np.log(np.asarray([[0.01, 0.97, 0.01, 0.01], [0.02, 0.02, 0.47, 0.49]]))
    assert pd.ctc_prefix_beam_search(p, beam_width=8) == [1, 3]
    assert pd.ctc_prefix_beam_search(p, beam_width=8, lm=lm, lm_weight=0.5) == [1, 2]


def test_char_ngram_lm_matches_jax_and_is_normalised():
    lm, jlm = _lm_pair(order=4, vocab=8, seed=3)
    for ctx in [(), (5,), (5, 6), (6, 7, 1), (3, 3, 3, 3), (7,) * 6]:
        probs = [lm.logp(ctx, s) for s in range(8)]
        assert max(abs(a - jlm.logp(ctx, s)) for s, a in enumerate(probs)) <= 1e-9
        np.testing.assert_allclose(np.exp(probs).sum(), 1.0, rtol=1e-9)
    with pytest.raises(ValueError, match="order"):
        pd.CharNGramLM(order=0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lm_json_loads_in_the_other_package(tmp_path, writer):
    lm, jlm = _lm_pair(order=3, vocab=32, seed=4)
    path = str(tmp_path / "lm.json")
    (lm if writer == "port" else jlm).save(path)
    back = (jd if writer == "port" else pd).CharNGramLM.load(path)
    assert back.order == 3 and back.vocab_size == 32
    assert back.counts == (jlm if writer == "port" else lm).counts
    for ctx in [(), (5,), (9, 11), (30, 31)]:
        for s in range(32):
            assert abs(back.logp(ctx, s) - lm.logp(ctx, s)) <= 1e-9
    # the same file bytes from both writers
    other = str(tmp_path / "other.json")
    (jlm if writer == "port" else lm).save(other)
    assert open(path).read() == open(other).read()


def test_fit_from_librispeech_matches_jax(tmp_path):
    chap = tmp_path / "7" / "9"
    chap.mkdir(parents=True)
    (chap / "7-9.trans.txt").write_text("7-9-0000 HELLO WORLD\n7-9-0001 HELLO AGAIN")
    lm = pd.CharNGramLM.fit_from_librispeech(str(tmp_path), order=3)
    assert lm.counts == jd.CharNGramLM.fit_from_librispeech(str(tmp_path), order=3).counts
    # H(11) E(5) L(15) L(15) O(8): after "L L" the corpus always sees "O"
    assert lm.logp((15, 15), 8) > lm.logp((15, 15), 5)


@pytest.mark.parametrize("labels", [[1], [1, 2], [1, 1], [2, 1, 2], [1, 1, 2]])
def test_forced_align_matches_jax(labels):
    rng = np.random.default_rng(len(labels) * 7 + labels[-1])
    for _ in range(4):
        lp = np.log(rng.dirichlet(np.ones(4), size=6))
        path, score = pd.ctc_forced_align(lp, labels, blank_id=0)
        want_path, want_score = jd.ctc_forced_align(lp, labels, blank_id=0)
        np.testing.assert_array_equal(path, want_path)
        assert path.dtype == want_path.dtype and abs(score - want_score) <= 1e-9


def test_forced_align_wide_trellis_and_edges():
    rng = np.random.default_rng(11)
    labels = [int(x) for x in rng.integers(1, 30, size=100)]
    lp = np.log(rng.dirichlet(np.ones(30), size=400))
    path, score = pd.ctc_forced_align(lp, labels, blank_id=0)
    np.testing.assert_array_equal(path, jd.ctc_forced_align(lp, labels, blank_id=0)[0])
    collapsed = [int(s) for i, s in enumerate(path) if s != 0 and (i == 0 or s != path[i - 1])]
    assert collapsed == labels and np.isfinite(score)
    flat = np.log(np.full((5, 3), 1 / 3))
    path, score = pd.ctc_forced_align(flat, [], blank_id=0)
    assert list(path) == [0] * 5 and score == pytest.approx(float(flat[:, 0].sum()))
    quarter = np.log(np.full((3, 4), 0.25))
    for labels, match in [([1, 0, 2], "blank"), ([9], "range"), ([1, 2, 3, 1], "frames"),
                          ([1, 1, 2], "frames")]:
        with pytest.raises(ValueError, match=match):
            pd.ctc_forced_align(quarter, labels, blank_id=0)


def _segments(mod, ids, probs=None, frame_seconds=0.02):
    return mod.ctc_word_segments(
        ids, frame_probs=probs, pad_id=0, delimiter_id=TOKENIZER.delimiter_id,
        id_to_token=TOKENIZER.id_to_token_mapping, frame_seconds=frame_seconds,
    )


def test_word_segments_match_jax():
    rng = np.random.default_rng(0)
    pool = np.array([0, 4] + list(range(5, 32)))
    for _ in range(40):
        n = int(rng.integers(1, 80))
        ids = np.repeat(pool[rng.integers(0, len(pool), size=n)], rng.integers(1, 4, size=n))
        probs = rng.uniform(0.05, 1.0, size=len(ids)).astype(np.float32)
        for p in (None, probs):
            assert _segments(pd, ids, p) == _segments(jd, ids, p)
    # the hand case of tests/test_timestamps.py: E E <pad> T | | A -> "ET A"
    text, words = _segments(pd, [5, 5, 0, 6, 4, 4, 7],
                            np.array([0.9, 0.8, 0.5, 0.6, 1.0, 1.0, 0.4], np.float32))
    assert text == "ET A"
    assert [(w["word"], w["start_frame"], w["end_frame"]) for w in words] == [("ET", 0, 4), ("A", 6, 7)]
    assert words[0]["confidence"] == pytest.approx((0.9 + 0.8 + 0.6) / 3, abs=1e-4)
    assert _segments(pd, [0, 0, 0]) == ("", []) and _segments(pd, [4, 0, 4]) == ("", [])


def test_segments_from_runs_matches_jax():
    rng = np.random.default_rng(2)
    frame, runs = 0, []
    for _ in range(60):
        fid, n = int(rng.choice([0, 4] + list(range(5, 32)))), int(rng.integers(1, 4))
        runs.append((fid, frame, frame + n, float(rng.uniform(0, n))))
        frame += n
    kw = dict(pad_id=0, delimiter_id=TOKENIZER.delimiter_id,
              id_to_token=TOKENIZER.id_to_token_mapping, frame_seconds=0.02)
    for with_probs in (False, True):
        got = pd.segments_from_runs(runs, with_probs=with_probs, **kw)
        assert got == jd.segments_from_runs(runs, with_probs=with_probs, **kw) and got[1]
