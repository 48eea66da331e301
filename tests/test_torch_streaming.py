"""The port's `StreamingTranscriber` (ports of the cases of
`tests/test_streaming.py`): incremental feeds reproduce the port's offline
`transcribe_long` exactly, with monotonically growing partials, and give the
JAX transcriber's text (and words, times within one frame) on the same
weights and pieces, f32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu import Wav2Vec2Config
from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu.models.modeling import init_wav2vec2_for_ctc_params
from gsoc_wav2vec2_tpu.streaming import StreamingTranscriber as JaxStreamingTranscriber
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax
from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.streaming import StreamingTranscriber

torch.set_num_threads(2)
TINY = dict(
    hidden_size=32, num_heads=2, num_layers=2, intermediate_size=64,
    filter_sizes=[16, 16], kernal_sizes=[10, 3], strides=[5, 2],
    dropout=0.0, survival_prob=1.0,
)
CHUNK, CONTEXT = 3000, 500


@pytest.fixture(scope="module")
def evaluators():
    """(JAX evaluator, port evaluator) on the same weights."""
    config = Wav2Vec2Config(**TINY)
    params = init_wav2vec2_for_ctc_params(jax.random.PRNGKey(0), config)
    model = Wav2Vec2ForCTC(port_config.Wav2Vec2Config(**dataclasses.asdict(config)), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return JaxEvaluator(config, params, compute_dtype=jnp.float32), GreedyCTCEvaluator(model)


def _audio(n, seed=0):
    return np.asarray(np.random.default_rng(seed).standard_normal(n), np.float32)


def _pieces(total, seed, most):
    rng = np.random.default_rng(seed)
    lo, out = 0, []
    while lo < total:
        n = int(rng.integers(1, most))
        out.append((lo, lo + n))
        lo += n
    return out


@pytest.mark.parametrize("total", [9500, 12000, CHUNK + 1])
def test_streaming_equals_transcribe_long(evaluators, total):
    jax_ev, ev = evaluators
    audio = _audio(total)
    want = ev.transcribe_long(audio, chunk_samples=CHUNK, context_samples=CONTEXT)
    st = StreamingTranscriber(ev, chunk_samples=CHUNK, context_samples=CONTEXT)
    jst = JaxStreamingTranscriber(jax_ev, chunk_samples=CHUNK, context_samples=CONTEXT)
    partials = []
    for lo, hi in _pieces(total, 1, 1700):
        partials.append(st.feed(audio[lo:hi]))
        assert jst.feed(audio[lo:hi]) == partials[-1]
    got = st.finish()
    assert got == want and got, "random-weights argmax should produce a non-empty string"
    assert got == jst.finish() == jax_ev.transcribe_long(audio, CHUNK, CONTEXT)
    for a, b in zip(partials, partials[1:] + [got]):  # committed text only grows
        assert b.startswith(a)


def test_streaming_short_audio_matches_one_shot(evaluators):
    _, ev = evaluators
    audio = _audio(CHUNK - 700, seed=3)
    st = StreamingTranscriber(ev, chunk_samples=CHUNK, context_samples=CONTEXT)
    st.feed(audio[:100])
    st.feed(audio[100:])
    assert st.finish() == ev.transcribe_long(audio, chunk_samples=CHUNK, context_samples=CONTEXT)


def test_streaming_normalized_windows_match_jax(evaluators):
    """normalize_window: each window zscored over its real samples, for raw
    sources; the JAX transcriber's text on the same pieces."""
    jax_ev, ev = evaluators
    raw = 3000.0 * np.sin(np.arange(9500) / 5.0).astype(np.float32) + 300 * _audio(9500, seed=9)
    st = StreamingTranscriber(ev, CHUNK, CONTEXT, normalize_window=True)
    jst = JaxStreamingTranscriber(jax_ev, CHUNK, CONTEXT, normalize_window=True)
    for lo in range(0, len(raw), 4000):
        assert st.feed(raw[lo : lo + 4000]) == jst.feed(raw[lo : lo + 4000])
    assert st.finish() == jst.finish()


def test_streaming_empty_and_errors(evaluators):
    _, ev = evaluators
    st = StreamingTranscriber(ev, chunk_samples=CHUNK, context_samples=CONTEXT)
    assert st.finish() == "" and st.finished
    with pytest.raises(ValueError, match="finished"):
        st.feed(np.zeros(10, np.float32))
    assert st.finish() == ""  # idempotent
    with pytest.raises(ValueError, match="exceed"):
        StreamingTranscriber(ev, chunk_samples=100, context_samples=60)
    with pytest.raises(ValueError, match="greedy"):
        StreamingTranscriber(GreedyCTCEvaluator(ev.model, beam_width=4))
    with pytest.raises(ValueError, match="word_timestamps"):
        _ = st.words


def test_streaming_memory_is_bounded(evaluators):
    """The buffer never keeps more than about one window behind the plan."""
    _, ev = evaluators
    st = StreamingTranscriber(ev, chunk_samples=CHUNK, context_samples=CONTEXT)
    audio = _audio(40 * CHUNK, seed=5)
    max_buf = 0
    for lo in range(0, len(audio), 2048):
        st.feed(audio[lo : lo + 2048])
        max_buf = max(max_buf, st._buf.size)
    assert max_buf <= 2 * CHUNK + 2048
    assert st.samples_fed == len(audio)


@pytest.mark.parametrize("total", [9500, CHUNK - 700])
def test_streaming_words_match_offline_segments(evaluators, total):
    """word_timestamps: `finish()`-time words equal the offline
    `transcribe_long_segments` (text and frame spans exactly, confidences to
    the order of float additions) and the JAX transcriber's; committed words
    never retract (all but the still-open last word are final)."""
    jax_ev, ev = evaluators
    audio = _audio(total, seed=5)
    want_text, want_words = ev.transcribe_long_segments(audio, CHUNK, CONTEXT)
    st = StreamingTranscriber(ev, CHUNK, CONTEXT, word_timestamps=True)
    jst = JaxStreamingTranscriber(jax_ev, CHUNK, CONTEXT, word_timestamps=True)
    snapshots = []
    for lo, hi in _pieces(total, 6, 1300):
        st.feed(audio[lo:hi])
        jst.feed(audio[lo:hi])
        snapshots.append(st.words)
    assert st.finish() == want_text == jst.finish()
    spans = [(w["word"], w["start_frame"], w["end_frame"]) for w in st.words]
    assert spans == [(w["word"], w["start_frame"], w["end_frame"]) for w in want_words] and spans
    for got, want, other in zip(st.words, want_words, jst.words):
        assert got["confidence"] == pytest.approx(want["confidence"], abs=2e-4)
        assert got["start"] == pytest.approx(want["start"])
        assert got["word"] == other["word"]
        assert abs(got["start_frame"] - other["start_frame"]) <= 1
        assert abs(got["end_frame"] - other["end_frame"]) <= 1
    for snap in snapshots:
        stable = [(w["word"], w["start_frame"]) for w in snap[:-1]]
        assert stable == [(w["word"], w["start_frame"]) for w in st.words[: len(stable)]]
