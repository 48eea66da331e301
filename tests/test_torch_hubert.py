"""HuBERT in the port, against `transformers.HubertForCTC` built from a
config and against the JAX package (`tests/test_hubert.py`'s cases), on the
CPU at its atol 2e-4.

HuBERT is wav2vec2 minus the pretraining quantizer, plus HF's
`feat_proj_layer_norm` knob: the port reads its `hubert.` names through
`convert/hf_torch.py`, in both families (post-norm base, stable-layer-norm
large), and runs it through every surface.  Nothing is downloaded.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_hubert import hubert_hf_config
from tests.test_torch_model import port_config_of
from tests.utils import matching_hf_config, requires_transformers, tiny_config

from gsoc_wav2vec2_tpu.convert.torch_to_jax import params_from_hf_model
from gsoc_wav2vec2_tpu.models.modeling import wav2vec2_for_ctc_forward as jax_forward
from gsoc_wav2vec2_tpu_torch.convert.hf_torch import state_dict_from_hf
from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor
from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC, wav2vec2_for_ctc_forward

torch.set_num_threads(2)
ATOL = 2e-4


def _hf_hubert(cfg, **overrides):
    import transformers

    hf_cfg = hubert_hf_config(cfg, **overrides)
    torch.manual_seed(0)
    return transformers.HubertForCTC(hf_cfg).eval()


def _port_from_hf(hf_model, cfg):
    pcfg = port_config_of(cfg)
    model = Wav2Vec2ForCTC(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_hf(hf_model.state_dict(), pcfg), strict=True)
    return model


def _compare(cfg, hf_model, seed=1):
    """The port's f32 logits against HF's and the JAX package's on the same
    weights; returns (port, HF) logits."""
    speech = np.random.RandomState(seed).randn(2, 4000).astype(np.float32)
    model = _port_from_hf(hf_model, cfg)
    with torch.no_grad():
        expected = hf_model(torch.from_numpy(speech)).logits.numpy()
        got = wav2vec2_for_ctc_forward(model, model.config, torch.from_numpy(speech)).numpy()
    params = params_from_hf_model(hf_model, cfg)
    via_jax = np.asarray(jax_forward(params, cfg, jnp.asarray(speech), None, training=False,
                                     compute_dtype=jnp.float32))
    assert got.shape == expected.shape == via_jax.shape
    np.testing.assert_allclose(got, expected, atol=ATOL)
    np.testing.assert_allclose(got, via_jax, atol=ATOL)
    return got, expected


@requires_transformers
def test_hubert_base_family_parity():
    """Post-norm, GroupNorm conv stack (hubert-base): logits and the greedy
    transcriptions."""
    cfg = tiny_config()
    got, expected = _compare(cfg, _hf_hubert(cfg))
    tok = Wav2Vec2Processor(is_tokenizer=True)
    for row_got, row_exp in zip(got.argmax(-1), expected.argmax(-1)):
        assert tok.decode(row_got) == tok.decode(row_exp)


@requires_transformers
def test_hubert_large_family_parity():
    """Stable pre-norm, LayerNorm conv stack with bias (hubert-large, e.g.
    facebook/hubert-large-ls960-ft)."""
    cfg = tiny_config(robust=True)
    _compare(cfg, _hf_hubert(cfg))


@requires_transformers
def test_hubert_no_feat_proj_layer_norm():
    """`feat_proj_layer_norm=False` (distilhubert-style): the projection
    LayerNorm is absent from the port's model and the forward skips it."""
    cfg = tiny_config(feat_proj_layer_norm=False)
    hf_model = _hf_hubert(cfg, feat_proj_layer_norm=False)
    _compare(cfg, hf_model)
    model = _port_from_hf(hf_model, cfg)
    assert model.wav2vec2.feature_projection.layer_norm is None
    assert not any("feature_projection.layer_norm" in k for k in model.state_dict())


@requires_transformers
def test_hubert_missing_masked_spec_embed_zero_filled():
    """HF omits `masked_spec_embed` when both mask probabilities are 0; the
    port zero-fills it (only SpecAugment reads it), as the JAX package does."""
    cfg = tiny_config()
    hf_cfg = hubert_hf_config(cfg)
    hf_cfg.mask_time_prob = 0.0
    hf_cfg.mask_feature_prob = 0.0
    import transformers

    torch.manual_seed(0)
    hf_model = transformers.HubertForCTC(hf_cfg).eval()
    assert not any("masked_spec_embed" in k for k in hf_model.state_dict())
    sd = state_dict_from_hf(hf_model.state_dict(), port_config_of(cfg))
    mse = sd["wav2vec2.masked_spec_embed"]
    assert mse.shape == (cfg.hidden_size,) and not mse.any()
    jax_mse = np.asarray(params_from_hf_model(hf_model, cfg)["wav2vec2"]["masked_spec_embed"])
    np.testing.assert_array_equal(mse.numpy(), jax_mse)


@requires_transformers
def test_convert_cli_handles_local_hubert_dir(tmp_path):
    """`cli.convert` detects model_type "hubert", passes its 0.004 gate, and
    its output loads in the port and in the JAX package, with the extension
    config field kept."""
    from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
    from gsoc_wav2vec2_tpu_torch.cli import convert as convert_cli

    cfg = tiny_config(feat_proj_layer_norm=False)
    hf_model = _hf_hubert(cfg, feat_proj_layer_norm=False)
    hf_dir, out_dir = str(tmp_path / "hf-hubert"), str(tmp_path / "converted")
    hf_model.save_pretrained(hf_dir)
    assert convert_cli.main(["--model_id", hf_dir, "--out", out_dir, "--device", "cpu"]) == out_dir

    model = Wav2Vec2ForCTC.from_pretrained(out_dir, device="cpu")
    assert model.config.feat_proj_layer_norm is False
    speech = np.random.RandomState(2).randn(1, 4000).astype(np.float32)
    with torch.no_grad():
        expected = hf_model(torch.from_numpy(speech)).logits.numpy()
        got = model(torch.from_numpy(speech)).numpy()
    np.testing.assert_allclose(got, expected, atol=ATOL)
    np.testing.assert_allclose(np.asarray(JaxWav2Vec2ForCTC.from_pretrained(out_dir)(speech)),
                               expected, atol=ATOL)


@requires_transformers
def test_convert_cli_gate_fails_a_planted_fault(tmp_path, monkeypatch):
    """A conversion that moves one weight by 0.5 fails the 0.004 gate and
    writes nothing."""
    from gsoc_wav2vec2_tpu_torch.cli import convert as convert_cli

    cfg = tiny_config()
    hf_dir, out_dir = str(tmp_path / "hf-hubert"), tmp_path / "converted"
    _hf_hubert(cfg).save_pretrained(hf_dir)

    def faulty(sd, config, with_lm_head=True):
        out = state_dict_from_hf(sd, config, with_lm_head=with_lm_head)
        out["lm_head.bias"] = out["lm_head.bias"] + 0.5
        return out

    monkeypatch.setattr(convert_cli, "state_dict_from_hf", faulty)
    with pytest.raises(RuntimeError, match="parity check failed"):
        convert_cli.convert(hf_dir, str(out_dir), device="cpu")
    assert not out_dir.exists()


@requires_transformers
@pytest.mark.parametrize("family", ["wav2vec2", "hubert"])
def test_from_pretrained_reads_raw_hf_snapshot(tmp_path, family):
    """A raw HF snapshot directory (HF-schema config.json + torch weights)
    loads through `from_pretrained` with no converter run."""
    import transformers

    cfg = tiny_config()
    if family == "hubert":
        hf_model = _hf_hubert(cfg)
    else:
        hf_model = transformers.Wav2Vec2ForCTC(matching_hf_config(cfg)).eval()
    hf_dir = str(tmp_path / f"hf-{family}")
    hf_model.save_pretrained(hf_dir)
    model = Wav2Vec2ForCTC.from_pretrained(hf_dir, device="cpu")
    assert model.config.num_layers == cfg.num_layers
    assert model.config.kernal_sizes == list(hf_model.config.conv_kernel)
    speech = np.random.RandomState(3).randn(1, 4000).astype(np.float32)
    with torch.no_grad():
        expected = hf_model(torch.from_numpy(speech)).logits.numpy()
        got = model(torch.from_numpy(speech)).numpy()
    np.testing.assert_allclose(got, expected, atol=ATOL)


def test_config_from_hf_dict_detection_and_errors():
    from gsoc_wav2vec2_tpu.models.config import config_from_hf_dict as jax_from_hf

    assert port_config.is_hf_config_dict({"model_type": "hubert"})
    assert port_config.is_hf_config_dict({"num_hidden_layers": 12})
    assert not port_config.is_hf_config_dict(port_config_of(tiny_config()).to_dict())
    with pytest.raises(ValueError, match="model_type"):
        port_config.config_from_hf_dict({"model_type": "whisper"})
    large = {"model_type": "hubert", "do_stable_layer_norm": True, "feat_extract_norm": "layer",
             "conv_bias": True, "feat_proj_layer_norm": False, "mask_time_prob": 0.08,
             "mask_feature_prob": 0.25, "mask_feature_length": 64}
    got = port_config.config_from_hf_dict(large)
    assert got.is_robust and got.attention_norm_type == "prenorm"
    assert got.feat_proj_layer_norm is False
    assert got.mask_time_prob == 0.08 and got.mask_feature_length == 64
    assert got.to_dict() == jax_from_hf(large).to_dict()


def test_pretraining_rejects_no_feat_proj_layer_norm():
    """The quantizer reads the normed conv features: the knob fails when the
    config is made."""
    with pytest.raises(ValueError, match="feat_proj_layer_norm"):
        port_config.Wav2Vec2PretrainingConfig(feat_proj_layer_norm=False)


@requires_transformers
def test_hf_snapshot_ignores_hf_layout_h5(tmp_path):
    """An HF repo's tf_model.h5 is HF's Keras layout: an HF-schema snapshot
    loads its torch weights and never opens that file."""
    cfg = tiny_config()
    hf_model = _hf_hubert(cfg)
    hf_dir = tmp_path / "hf-snap"
    hf_model.save_pretrained(str(hf_dir))
    (hf_dir / "tf_model.h5").write_bytes(b"\x89HDF-not-really")
    model = Wav2Vec2ForCTC.from_pretrained(str(hf_dir), device="cpu")
    speech = np.random.RandomState(4).randn(1, 4000).astype(np.float32)
    with torch.no_grad():
        expected = hf_model(torch.from_numpy(speech)).logits.numpy()
        got = model(torch.from_numpy(speech)).numpy()
    np.testing.assert_allclose(got, expected, atol=ATOL)


@requires_transformers
def test_hubert_runs_decode_surfaces():
    """A converted HuBERT model drives the decode surfaces: greedy batch,
    word segments, beam search, forced alignment; the greedy texts equal the
    JAX evaluator's."""
    from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator

    cfg = tiny_config()
    hf_model = _hf_hubert(cfg)
    model = _port_from_hf(hf_model, cfg)
    speech = np.random.RandomState(5).randn(2, 4000).astype(np.float32)
    ev = GreedyCTCEvaluator(model)
    texts = ev.predict_batch(speech)
    jax_ev = JaxEvaluator(cfg, params_from_hf_model(hf_model, cfg), compute_dtype=jnp.float32)
    assert texts == jax_ev.predict_batch(speech)
    segs = ev.predict_segments(speech)
    assert [t for t, _ in segs] == texts
    beam = GreedyCTCEvaluator(model, beam_width=4).predict_batch(speech)
    assert len(beam) == 2 and all(isinstance(t, str) for t in beam)
    text, words = ev.align_segments(speech[0], "HELLO WORLD")
    assert text == "HELLO WORLD"
    assert [w["word"] for w in words] == ["HELLO", "WORLD"]


def test_feat_proj_layer_norm_stays_out_of_reference_json(tmp_path):
    """The default (True) is left out of config.json, so the reference reads
    it back; False is written, and both packages read it."""
    from gsoc_wav2vec2_tpu.models.config import Wav2Vec2Config as JaxConfig

    cfg = port_config_of(tiny_config())
    assert "feat_proj_layer_norm" not in cfg.to_dict()
    off = port_config_of(tiny_config(feat_proj_layer_norm=False))
    assert off.to_dict()["feat_proj_layer_norm"] is False
    off.save_pretrained(str(tmp_path))
    d = json.loads((tmp_path / "config.json").read_text())
    assert JaxConfig(**d).feat_proj_layer_norm is False
