"""The port's greedy-CTC inference against the JAX evaluator, f32 on the CPU."""

import json
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import build_pair, port_config_of
from tests.utils import matching_hf_config, requires_transformers, tiny_config

from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu import Wav2Vec2Processor as JaxProcessor
from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu.evaluation import plan_chunks as jax_plan_chunks
from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator, plan_chunks
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC

torch.set_num_threads(2)


def _evaluators(robust: bool, seed: int):
    cfg, params, _, model = build_pair(robust, seed=seed)
    return (
        JaxEvaluator(cfg, params, compute_dtype=jnp.float32),
        GreedyCTCEvaluator(model),
    )


@pytest.mark.parametrize("robust", [False, True])
def test_predict_batch_matches_jax_with_ragged_lengths(robust):
    jax_ev, ev = _evaluators(robust, seed=11)
    assert ev.compute_dtype == torch.float32
    rng = np.random.default_rng(0)
    speech = rng.standard_normal((3, 8000)).astype(np.float32)
    lengths = np.array([8000, 6000, 4321])
    for i, l in enumerate(lengths):
        speech[i, l:] = 0.0
    want = jax_ev.predict_batch(speech, lengths)
    got = ev.predict_batch(speech, lengths)
    assert got == want
    assert any(got)


@pytest.mark.parametrize("robust", [False, True])
def test_transcribe_long_matches_jax_multi_chunk(robust):
    jax_ev, ev = _evaluators(robust, seed=12)
    audio = np.random.default_rng(1).standard_normal(21000).astype(np.float32)
    kwargs = dict(chunk_samples=8000, context_samples=1000)
    assert len(plan_chunks(21000, 8000, 1000, ev.config.conv_output_length)) > 2
    assert ev.transcribe_long(audio, **kwargs) == jax_ev.transcribe_long(audio, **kwargs)


def test_tiny_inputs_decode_to_nothing():
    """conv_output_length goes negative for a few samples: the lengths are
    clipped to 0 frames, as in the JAX evaluator."""
    jax_ev, ev = _evaluators(False, seed=13)
    speech = np.random.default_rng(2).standard_normal((2, 8000)).astype(np.float32)
    lengths = np.array([8000, 12])
    assert ev.predict_batch(speech, lengths) == jax_ev.predict_batch(speech, lengths)
    assert ev.predict_batch(speech, lengths)[1] == ""


@pytest.mark.parametrize("total", [30000, 24000, 8001, 47999, 640000])
def test_plan_chunks_matches_jax(total):
    f = port_config_of(tiny_config()).conv_output_length
    for chunk, ctx, stride in ((8000, 1000, None), (246000, 16000, 320)):
        assert plan_chunks(total, chunk, ctx, f, stride) == jax_plan_chunks(total, chunk, ctx, f, stride)


def _hf_dir(tmp_path, seed=0):
    import transformers

    cfg = tiny_config()
    torch.manual_seed(seed)
    hf = transformers.Wav2Vec2ForCTC(matching_hf_config(cfg)).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=False)
    assert (tmp_path / "pytorch_model.bin").is_file()
    return hf


@requires_transformers
def test_from_pretrained_hf_bin_matches_jax(tmp_path):
    hf = _hf_dir(tmp_path)
    jax_model = JaxWav2Vec2ForCTC.from_pretrained(str(tmp_path))
    model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    speech = np.random.default_rng(3).standard_normal((2, 8000)).astype(np.float32)
    want = np.asarray(jax_model(speech))
    with torch.no_grad():
        got = model(torch.from_numpy(speech)).numpy()
        hf_logits = hf(torch.from_numpy(speech)).logits.numpy()
    np.testing.assert_allclose(got, want, atol=4e-3)
    np.testing.assert_allclose(got, hf_logits, atol=4e-3)


def _write_wav(path, audio, rate=16000):
    pcm = np.clip(np.round(audio * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


@requires_transformers
def test_cli_transcript_matches_jax_evaluator(tmp_path, monkeypatch, capsys):
    from gsoc_wav2vec2_tpu.data.native_io import read_sound as jax_read_sound
    from gsoc_wav2vec2_tpu_torch.cli import transcribe

    model_dir = tmp_path / "model"
    _hf_dir(model_dir, seed=4)
    wav = tmp_path / "clip.wav"
    audio = np.random.default_rng(5).uniform(-0.5, 0.5, 20000).astype(np.float32)
    _write_wav(wav, audio)

    jax_model = JaxWav2Vec2ForCTC.from_pretrained(str(model_dir))
    samples, rate = jax_read_sound(str(wav))
    speech = np.asarray(JaxProcessor(is_tokenizer=False)(samples), np.float32)
    jax_ev = JaxEvaluator(jax_model.config, jax_model.params, compute_dtype=jnp.float32)
    want = jax_ev.transcribe_long(speech, chunk_samples=8000, context_samples=1000)

    monkeypatch.setattr(sys, "argv", [
        "transcribe", "--model_dir", str(model_dir), "--device", "cpu",
        "--chunk_samples", "8000", "--context_samples", "1000", str(wav),
    ])
    transcribe.main()
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert lines == [{"file": str(wav), "transcription": want}]


def test_read_sound_refuses_flac(tmp_path):
    """A FLAC that is not one is refused; a real one decodes through the
    port's codec to the JAX package's samples."""
    from flac_encoder import encode_flac
    from gsoc_wav2vec2_tpu.data.native_io import read_sound as jax_read_sound
    from gsoc_wav2vec2_tpu_torch.data.audio import read_sound

    bad = tmp_path / "x.flac"
    bad.write_bytes(b"not a flac stream")
    with pytest.raises(OSError):
        read_sound(str(bad))
    good = tmp_path / "y.flac"
    sig = np.round(np.sin(np.arange(5000) / 7.0) * 3000).astype(np.int64)
    good.write_bytes(encode_flac(sig, subframe_kind="fixed", order=2, rice_param=7))
    got, rate = read_sound(str(good))
    want, want_rate = jax_read_sound(str(good))
    assert rate == want_rate == 16000
    np.testing.assert_array_equal(got, want)


def test_read_wav_matches_native_reader(tmp_path):
    from gsoc_wav2vec2_tpu.data.native_io import read_sound as jax_read_sound
    from gsoc_wav2vec2_tpu_torch.data.audio import read_sound

    wav = tmp_path / "a.wav"
    _write_wav(wav, np.random.default_rng(6).uniform(-1, 1, 3001).astype(np.float32), rate=8000)
    got, rate = read_sound(str(wav))
    want, want_rate = jax_read_sound(str(wav))
    assert rate == want_rate == 8000
    np.testing.assert_array_equal(got, want)


def test_processor_normalize_matches_jax():
    from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor

    x = np.random.default_rng(7).standard_normal(1000).astype(np.float32) * 3 + 1
    want = np.asarray(JaxProcessor(is_tokenizer=False)(x))
    proc = Wav2Vec2Processor(is_tokenizer=False)
    np.testing.assert_allclose(proc(x), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(proc(torch.from_numpy(x)).numpy(), want, rtol=1e-5, atol=1e-5)
    tok = Wav2Vec2Processor(is_tokenizer=True)
    ids = tok("HELLO THERE-WORLD")
    assert ids == JaxProcessor(is_tokenizer=True)("HELLO THERE-WORLD")
    assert tok.decode(ids) == "HELO THERE WORLD"
