"""The port's WER evaluation entry points against the JAX evaluator, f32 on
the CPU: the same bucket boundaries, the same forwards (batch shapes, in
order), the same transcripts and the same WER, on the tiny configs of both
families."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import build_pair

from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu.evaluation import default_buckets as jax_default_buckets
from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator, default_buckets

torch.set_num_threads(2)
BUCKETS = [3000, 5000, 8000]
WORDS = ["A", "IT", "THE", "CAT", "HELLO", "WORLD", "OF"]


def _evaluators(robust, seed):
    cfg, params, _, model = build_pair(robust, seed=seed)
    return JaxEvaluator(cfg, params, compute_dtype=jnp.float32), GreedyCTCEvaluator(model)


def _samples(n, seed, longest=9000):
    """Utterances of mixed length, a few past the largest bucket, with
    reference strings (the weights are random: the point is that both
    evaluators score the same hypotheses against them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        audio = rng.standard_normal(int(rng.integers(1200, longest))).astype(np.float32)
        text = " ".join(rng.choice(WORDS, size=int(rng.integers(1, 5))))
        out.append((audio, text))
    return out


def _recording(ev):
    """Wrap `predict_batch`: the (rows, samples) shape, the lengths and the
    transcripts of every forward."""
    calls = []
    inner = ev.predict_batch

    def predict_batch(speech, sample_lengths=None):
        out = inner(speech, sample_lengths)
        calls.append((tuple(np.shape(speech)), tuple(int(l) for l in sample_lengths), tuple(out)))
        return out

    ev.predict_batch = predict_batch
    return calls


@pytest.mark.parametrize("max_len,num", [(400000, 8), (246000, 4), (100000, 3)])
def test_default_buckets_match_jax(max_len, num):
    assert default_buckets(max_len, num) == jax_default_buckets(max_len, num)
    assert default_buckets() == jax_default_buckets()


@pytest.mark.parametrize("robust", [False, True])
def test_evaluate_bucketed_matches_jax(robust):
    jax_ev, ev = _evaluators(robust, seed=21)
    samples = _samples(11, seed=1)
    want_calls, got_calls = _recording(jax_ev), _recording(ev)
    want = jax_ev.evaluate_bucketed(samples, batch_size=3, buckets=BUCKETS)
    got = ev.evaluate_bucketed(samples, batch_size=3, buckets=BUCKETS)
    assert got == want and got[1] == len(samples)
    # the same forwards, in the same order: shape, true lengths, transcripts
    assert got_calls == want_calls
    per_bucket = {b: sum(1 for shape, _, _ in got_calls if shape[1] == b) for b in BUCKETS}
    assert sum(per_bucket.values()) == len(got_calls) and all(per_bucket.values())
    assert any(text for _, _, texts in got_calls for text in texts)
    # audio past the largest bucket is cut to it
    assert max(max(lengths) for _, lengths, _ in got_calls) == BUCKETS[-1]


@pytest.mark.parametrize("robust", [False, True])
def test_evaluate_padded_matches_jax(robust):
    jax_ev, ev = _evaluators(robust, seed=22)
    samples = _samples(7, seed=2, longest=8000)
    want_calls, got_calls = _recording(jax_ev), _recording(ev)
    want = jax_ev.evaluate_padded(samples, batch_size=3, pad_to=8000)
    got = ev.evaluate_padded(samples, batch_size=3, pad_to=8000)
    assert got == want and got[1] == 7
    assert got_calls == want_calls
    assert [shape for shape, _, _ in got_calls] == [(3, 8000), (3, 8000), (1, 8000)]


def test_evaluate_bucketed_defaults_and_generators():
    """`samples` may be a one-shot iterable, and the default buckets apply
    when none are given (every tiny utterance lands in the first)."""
    _, ev = _evaluators(True, seed=23)
    calls = _recording(ev)
    samples = _samples(3, seed=3, longest=4000)
    wer, n = ev.evaluate_bucketed(iter(samples), batch_size=2)
    assert n == 3 and wer >= 0.0
    assert [shape for shape, _, _ in calls] == [(2, default_buckets()[0]), (1, default_buckets()[0])]


def test_padded_rows_decode_nothing():
    """A row whose length is 0 (padding only) decodes to the empty string in
    both families, as the JAX evaluator's filler rows do."""
    for robust in (False, True):
        jax_ev, ev = _evaluators(robust, seed=24)
        speech = np.zeros((2, 4000), np.float32)
        speech[0] = np.random.default_rng(4).standard_normal(4000)
        lengths = np.array([4000, 0])
        got = ev.predict_batch(speech, lengths)
        assert got == jax_ev.predict_batch(speech, lengths) and got[1] == ""
