"""The port's evaluator decode surface against the JAX evaluator, f32 on the
CPU, tiny configs of both families with the same weights: the three step
modes against the JAX `_step` (log-probs within 4e-3, the logit tolerance of
`tests/test_parity.py`; ids equal), `predict_segments`,
`transcribe_long_segments`, `align_segments` (with `pad_to`) and the beam
`predict_batch` / `transcribe_long` (with and without LM fusion): equal
strings and words, word times within one frame; plus ports of the evaluator
cases of `tests/test_timestamps.py`, `tests/test_forced_align.py` and
`tests/test_beam_decode.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import build_pair

from gsoc_wav2vec2_tpu.decoding import CharNGramLM as JaxLM
from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu_torch.decoding import CharNGramLM
from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator

torch.set_num_threads(2)
LOGP_TOL = 4e-3
CHUNK, CONTEXT = 8000, 1000


@pytest.fixture(scope="module", params=[False, True], ids=["base", "robust"])
def pair(request):
    cfg, params, _, model = build_pair(request.param, seed=31)
    return cfg, params, model


def _evaluators(pair, lms=(None, None), **kw):
    """(JAX evaluator, port evaluator) on the same weights; `lms` = (the
    port's LM, the JAX package's LM) fitted on the same sequences."""
    cfg, params, model = pair
    return (JaxEvaluator(cfg, params, compute_dtype=jnp.float32, lm=lms[1], **kw),
            GreedyCTCEvaluator(model, lm=lms[0], **kw))


def _lms(seed=0):
    rng = np.random.default_rng(seed)
    seqs = [[int(s) for s in rng.integers(4, 32, size=int(rng.integers(3, 15)))] for _ in range(40)]
    return CharNGramLM(3, 32).fit(seqs), JaxLM(3, 32).fit(seqs)


def _batch(seed, b=3, l=6000):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((b, l)).astype(np.float32)
    lengths = np.array([l, l - 1700, 2300][:b], np.int64)
    for i, n in enumerate(lengths):
        speech[i, n:] = 0.0
    return speech, lengths


def _assert_words_close(got, want):
    assert [w["word"] for w in got] == [w["word"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["start_frame"] - w["start_frame"]) <= 1 and abs(g["end_frame"] - w["end_frame"]) <= 1
        assert g["start"] == pytest.approx(g["start_frame"] * 320 / 16000)
        assert g["confidence"] == pytest.approx(w["confidence"], abs=2e-3)


def _assert_segments_close(got, want):
    assert got[0] == want[0]
    _assert_words_close(got[1], want[1])


@pytest.mark.parametrize("mode", ["argmax", "logprobs", "scored"])
def test_step_modes_match_jax(pair, mode):
    jax_ev, ev = _evaluators(pair)
    speech, lengths = _batch(1)
    mask = (np.arange(speech.shape[1])[None, :] < lengths[:, None]).astype(np.float32)
    use_mask = ev.use_attention_mask
    jargs = (jnp.asarray(speech), jnp.asarray(mask)) if use_mask else (jnp.asarray(speech),)
    want, want_len = jax_ev._step(use_mask, mode)(jax_ev.params, *jargs)
    got, got_len = ev._step(speech, mask if use_mask else None, mode)
    if use_mask:
        np.testing.assert_array_equal(got_len, np.asarray(want_len))
    else:
        assert got_len is None
    if mode == "argmax":
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, np.asarray(want))
    elif mode == "logprobs":
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), atol=LOGP_TOL, rtol=0)
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)
    else:
        (ids, maxlogp), (wids, wmax) = got, want
        assert ids.dtype == np.int32 and maxlogp.dtype == np.float32
        np.testing.assert_array_equal(ids, np.asarray(wids))
        np.testing.assert_allclose(maxlogp, np.asarray(wmax), atol=LOGP_TOL, rtol=0)
        # the three modes agree with each other on the port
        np.testing.assert_array_equal(ids, ev._step(speech, mask if use_mask else None, "argmax")[0])
        lp = ev._step(speech, mask if use_mask else None, "logprobs")[0]
        np.testing.assert_allclose(maxlogp, lp.max(-1), atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        ev._step(speech, None, "probs")


def test_predict_segments_match_jax(pair):
    jax_ev, ev = _evaluators(pair)
    speech, lengths = _batch(2)
    got = ev.predict_segments(speech, lengths)
    want = jax_ev.predict_segments(speech, lengths)
    assert len(got) == 3 and any(words for _, words in got)
    for g, w, text in zip(got, want, ev.predict_batch(speech, lengths)):
        _assert_segments_close(g, w)
        assert g[0] == text
        prev_end = 0
        for word in g[1]:
            assert prev_end <= word["start_frame"] < word["end_frame"]
            prev_end = word["end_frame"]
            assert 0.0 < word["confidence"] <= 1.0
    # a filler row of length 0 decodes nothing
    speech[2] = 0.0
    lengths[2] = 0
    assert ev.predict_segments(speech, lengths)[2] == ("", [])


def test_transcribe_long_segments_match_jax(pair):
    jax_ev, ev = _evaluators(pair)
    rng = np.random.default_rng(3)
    audio = np.zeros(20000, np.float32)
    for start in range(0, 20000, 3000):
        audio[start : start + 1500] = rng.standard_normal(1500)
    got = ev.transcribe_long_segments(audio, CHUNK, CONTEXT)
    _assert_segments_close(got, jax_ev.transcribe_long_segments(audio, CHUNK, CONTEXT))
    assert got[0] == ev.transcribe_long(audio, CHUNK, CONTEXT)
    cfg = pair[0]
    assert got[1] and max(w["end_frame"] for w in got[1]) > int(cfg.conv_output_length(CHUNK))
    assert max(w["end_frame"] for w in got[1]) <= int(cfg.conv_output_length(20000))
    # one window over the whole utterance is predict_segments; so is short audio
    assert ev.transcribe_long_segments(audio, chunk_samples=20000) == ev.predict_segments(audio[None])[0]
    assert ev.transcribe_long_segments(audio[:5000], CHUNK) == ev.predict_segments(audio[None, :5000])[0]


@pytest.mark.parametrize("pad_to", [None, 8000])
def test_align_segments_match_jax(pair, pad_to):
    jax_ev, ev = _evaluators(pair)
    audio = np.random.default_rng(4).standard_normal(5000).astype(np.float32)
    got = ev.align_segments(audio, "hello,  world!", pad_to=pad_to)
    _assert_segments_close(got, jax_ev.align_segments(audio, "hello,  world!", pad_to=pad_to))
    assert got[0] == "HELLO WORLD" and [w["word"] for w in got[1]] == ["HELLO", "WORLD"]
    if ev.use_attention_mask:  # the mask hides the padding entirely
        assert got == ev.align_segments(audio, "HELLO WORLD")
    with pytest.raises(ValueError, match="frames"):
        ev.align_segments(audio[:1200], "THE QUICK BROWN FOX " * 10)
    with pytest.raises(ValueError, match="one utterance"):
        ev.align_segments(audio[None], "HELLO")


def test_align_segments_long_form_match_jax(pair):
    jax_ev, ev = _evaluators(pair)
    audio = np.random.default_rng(5).standard_normal(24000).astype(np.float32)
    transcript = "SHE HAD YOUR DARK SUIT IN GREASY WASH WATER ALL YEAR"
    got = ev.align_segments(audio, transcript, chunk_samples=CHUNK, context_samples=CONTEXT)
    _assert_segments_close(got, jax_ev.align_segments(audio, transcript, chunk_samples=CHUNK,
                                                      context_samples=CONTEXT))
    assert [w["word"] for w in got[1]] == transcript.split()
    assert max(w["end_frame"] for w in got[1]) > int(pair[0].conv_output_length(CHUNK))
    assert ev.align_segments(audio, transcript, chunk_samples=24000)[0] == transcript


@pytest.mark.parametrize("width,fused", [(1, False), (4, False), (16, True)])
def test_beam_decode_matches_jax(pair, width, fused):
    fusion = dict(lms=_lms(), lm_weight=0.6, token_bonus=0.2) if fused else {}
    jax_ev, ev = _evaluators(pair, beam_width=width, **fusion)
    speech, lengths = _batch(6)
    got = ev.predict_batch(speech, lengths)
    assert got == jax_ev.predict_batch(speech, lengths) and any(got)
    audio = np.random.default_rng(7).standard_normal(20000).astype(np.float32)
    long_text = ev.transcribe_long(audio, CHUNK, CONTEXT)
    assert long_text == jax_ev.transcribe_long(audio, CHUNK, CONTEXT) and long_text
    with pytest.raises(ValueError, match="greedy"):
        ev.predict_segments(speech, lengths)
    with pytest.raises(ValueError, match="greedy"):
        ev.transcribe_long_segments(audio)


def test_beam_evaluates_through_predict_batch(pair):
    """`evaluate_padded` / `evaluate_bucketed` decode by beam through
    `predict_batch`: the JAX evaluator's WER and sample count."""
    jax_ev, ev = _evaluators(pair, beam_width=4)
    rng = np.random.default_rng(8)
    samples = [(rng.standard_normal(int(rng.integers(1500, 7000))).astype(np.float32), "A CAT")
               for _ in range(5)]
    assert ev.evaluate_bucketed(samples, batch_size=2, buckets=[4000, 8000]) == \
        jax_ev.evaluate_bucketed(samples, batch_size=2, buckets=[4000, 8000])
    assert ev.evaluate_padded(samples, batch_size=2, pad_to=8000) == \
        jax_ev.evaluate_padded(samples, batch_size=2, pad_to=8000)


def test_frame_seconds(pair):
    jax_ev, ev = _evaluators(pair)
    assert ev.frame_seconds == jax_ev.frame_seconds == 0.02
