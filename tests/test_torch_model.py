"""The port's model against the JAX model: weight bridge and whole forwards."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax, params_to_jax
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import modeling

torch.set_num_threads(2)
SEQLEN = 8000


def port_config_of(cfg):
    cls = port_config.RobustWav2Vec2Config if cfg.is_robust else port_config.Wav2Vec2Config
    return cls(**dataclasses.asdict(cfg))


def build_pair(robust: bool, with_head: bool = True, seed: int = 0):
    """JAX params from the JAX initialiser, loaded into the port's model."""
    cfg = tiny_config(robust=robust)
    init = (jax_modeling.init_wav2vec2_for_ctc_params if with_head
            else jax_modeling.init_wav2vec2_params)
    params = init(jax.random.PRNGKey(seed), cfg)
    pcfg = port_config_of(cfg)
    cls = modeling.Wav2Vec2ForCTC if with_head else modeling.Wav2Vec2Model
    model = cls(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, params, pcfg, model


def _equal_trees(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("robust", [False, True])
def test_jax_bridge_round_trips_bit_exactly(robust):
    _, params, _, model = build_pair(robust)
    back = params_to_jax(model.state_dict())
    _equal_trees(jax.tree_util.tree_map(np.asarray, params), back)


def _speech(b, seed=0):
    return np.random.RandomState(seed).randn(b, SEQLEN).astype(np.float32)


@pytest.mark.parametrize("robust", [False, True])
def test_hidden_states_match_jax(robust):
    cfg, params, pcfg, model = build_pair(robust, with_head=False)
    speech = _speech(2)
    want = np.asarray(jax_modeling.wav2vec2_forward(params, cfg, jnp.asarray(speech)))
    with torch.no_grad():
        got = modeling.wav2vec2_forward(model, pcfg, torch.from_numpy(speech)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("robust", [False, True])
def test_logits_match_jax_with_ragged_mask(robust):
    cfg, params, pcfg, model = build_pair(robust, seed=1)
    b = 3
    speech = _speech(b, seed=2)
    lengths = [SEQLEN, SEQLEN - 1700, SEQLEN - 3333]
    mask = np.zeros((b, SEQLEN), np.int64)
    for i, l in enumerate(lengths):
        mask[i, :l] = 1
        speech[i, l:] = 0.0
    want = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech), jnp.asarray(mask)))
    with torch.no_grad():
        got = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(speech), torch.from_numpy(mask)).numpy()
        unmasked = model(torch.from_numpy(speech)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=4e-3)
    want_unmasked = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech)))
    np.testing.assert_allclose(unmasked, want_unmasked, atol=4e-3)


def test_bf16_cpu_path_tracks_f32():
    """The bf16 path on the CPU (the fused front end's plain versions) stays
    within bf16 noise of the f32 forward."""
    _, _, pcfg, model = build_pair(False, seed=3)
    x = torch.from_numpy(_speech(2, seed=4))
    with torch.no_grad():
        f32 = modeling.wav2vec2_for_ctc_forward(model, pcfg, x)
        bf16 = modeling.wav2vec2_for_ctc_forward(model, pcfg, x, compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    scale = f32.abs().max()
    assert (bf16 - f32).abs().max() < 0.1 * scale


def test_model_without_device_raises_when_cuda_is_missing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is then valid")
    cfg = port_config_of(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        modeling.Wav2Vec2ForCTC(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        modeling.Wav2Vec2Model(cfg)


def test_seeded_init_is_reproducible():
    cfg = port_config_of(tiny_config())
    a = modeling.Wav2Vec2ForCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = modeling.Wav2Vec2ForCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    assert not any(p.requires_grad for p in a.parameters())
