"""The conv front end at the widths past 512 and between, against the JAX package on the CPU.

The port's instances take every multiple of 128 from 128 to 1024 (JAX sends
each to its Pallas kernels).  Here, at C = 384 (no multiple of 256: the
narrow kernel's atoms split unevenly over its cluster) and 1024 (two CTAs
share a row's columns and the robust LayerNorm is split between them), the
plain versions the wrappers run for a CPU tensor against the Pallas kernels
in interpret mode, and a tiny model's bf16 feature encoder against JAX's.
Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.ops.pallas import conv_frontend as jax_cf
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend

torch.set_num_threads(2)
WIDTHS = (384, 1024)
SEQLEN = 8000


def _t(a):
    return torch.tensor(np.asarray(a))


def _base_inputs(length, c, seed):
    rng = np.random.default_rng(seed)
    wave = rng.standard_normal((2, length)).astype(np.float32)
    w0 = (rng.standard_normal((10, 1, c)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((3, c, c)) * (1.5 / c ** 0.5)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return wave, w0, gamma, beta, w1


def _robust_inputs(length, c, seed):
    rng = np.random.default_rng(seed)
    vec = lambda scale, offset: (offset + scale * rng.standard_normal(c)).astype(np.float32)
    wave = rng.standard_normal((2, length)).astype(np.float32)
    w0 = (rng.standard_normal((10, 1, c)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((3, c, c)) * 0.05).astype(np.float32)
    # waveform, w0, b0, gamma0, beta0, w1, b1, gamma1, beta1
    return (wave, w0, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0),
            w1, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0))


def _close(got: torch.Tensor, want) -> None:
    """atol / rtol 0.05 and mean error 5e-3, the bounds the JAX package
    holds its own kernel to against XLA (tests/test_conv_frontend.py)."""
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    assert np.abs(got - want).mean() < 5e-3


@pytest.mark.parametrize("length", [16000, 8007])
@pytest.mark.parametrize("c", WIDTHS)
def test_fused_conv01_plain_matches_pallas_at_wide_fronts(c, length):
    args = _base_inputs(length, c, seed=c + length)
    want = jax_cf.fused_conv01(*map(jnp.asarray, args), gelu_approx=True, interpret=True)
    _close(conv_frontend.fused_conv01(*map(_t, args), eps=1e-5, gelu_approx=True), want)


@pytest.mark.parametrize("length", [16000, 8007])
@pytest.mark.parametrize("c", WIDTHS)
def test_fused_conv01_robust_plain_matches_pallas_at_wide_fronts(c, length):
    args = _robust_inputs(length, c, seed=c + length + 1)
    want = jax_cf.fused_conv01_robust(*map(jnp.asarray, args), gelu_approx=True, interpret=True)
    _close(conv_frontend.fused_conv01_robust(*map(_t, args), eps=1e-5, gelu_approx=True), want)


def _jax_groupnorm_scale_shift(wave, w0, gamma, beta, eps=1e-5):
    """`_window_stats` (the Pallas call, interpret mode) on the phase arrays
    `fused_conv01` builds, then its XLA tail (conv_frontend.py:239-249)."""
    b, length = wave.shape
    c = w0.shape[-1]
    t0 = conv_frontend.conv0_length(length)
    t1 = 1 + (t0 - 3) // 2
    r = -(-t1 // jax_cf.TILE) * jax_cf.TILE + jax_cf.TILE
    xb = jnp.pad(jnp.asarray(wave).astype(jnp.bfloat16), ((0, 0), (0, 10 * r + 15 - length)))
    pa = xb[:, : 10 * r].reshape(b, r, 10)
    pb = xb[:, 5 : 5 + 10 * r].reshape(b, r, 10)
    gram, row_sum = jax_cf._window_stats(pa, pb, (t0 + 1) // 2, t0 // 2, True)
    w0f = jnp.asarray(w0).reshape(10, c)
    mean = (row_sum @ w0f) / t0
    sumsq = jnp.einsum("bjk,jc,kc->bc", gram, w0f, w0f)
    var = jnp.maximum(sumsq / t0 - mean * mean, 0.0)
    scale = jax.lax.rsqrt(var + eps) * jnp.asarray(gamma)[None, :]
    shift = jnp.asarray(beta)[None, :] - mean * scale
    return scale, shift


@pytest.mark.parametrize("c", WIDTHS)
def test_groupnorm_stats_plain_matches_pallas_at_wide_fronts(c):
    wave, w0, gamma, beta, _ = _base_inputs(12003, c, seed=c)
    want = _jax_groupnorm_scale_shift(wave, w0, gamma, beta)
    x = _t(wave).to(torch.bfloat16)
    got = conv_frontend.groupnorm_stats(x, conv_frontend.conv0_length(wave.shape[1]), _t(w0),
                                        _t(gamma), _t(beta), 1e-5)
    # rtol 1e-5 of each output's scale: f32 sums over ~t0 windows in other orders
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, c)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("robust", [False, True])
def test_tiny_feature_encoder_at_wide_fronts_matches_jax_bf16(monkeypatch, robust):
    """The tiny config with a front end of 384 (base) or 1024 (robust)
    channels: the port's bf16 feature encoder on the CPU (the fused pair's
    plain version, once) against JAX's bf16 feature encoder (XLA's
    convolutions on the CPU) and its f32 one, within bf16 noise (10% of the
    output's scale, as the tiny bf16 parity tests); the card takes the
    kernels at this width."""
    c = 1024 if robust else 384
    cfg = tiny_config(robust=robust, filter_sizes=[c] * 7)
    pcls = port_config.RobustWav2Vec2Config if robust else port_config.Wav2Vec2Config
    pcfg = pcls(**dataclasses.asdict(cfg))
    assert conv_frontend.supports(pcfg) and conv_frontend.fusable(pcfg)
    params = jax_modeling.init_wav2vec2_params(jax.random.PRNGKey(7), cfg)
    model = modeling.Wav2Vec2Model(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    speech = np.random.default_rng(8).standard_normal((2, SEQLEN)).astype(np.float32)
    want = np.asarray(jax_modeling.feature_encoder_forward(
        params["feature_extractor"], cfg, jnp.asarray(speech), compute_dtype=jnp.bfloat16), np.float32)
    want32 = np.asarray(jax_modeling.feature_encoder_forward(
        params["feature_extractor"], cfg, jnp.asarray(speech)), np.float32)
    name = "fused_conv01_robust" if robust else "fused_conv01"
    fused, calls = getattr(conv_frontend, name), []
    monkeypatch.setattr(conv_frontend, name, lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    with torch.no_grad():
        got = modeling.feature_encoder_forward(model.feature_extractor, pcfg,
                                               torch.from_numpy(speech), torch.bfloat16)
    assert calls == [1]
    got = got.float().numpy()
    assert got.shape == want.shape == (2, pcfg.conv_output_length(SEQLEN), c)
    for ref in (want, want32):
        assert np.abs(got - ref).max() < 0.1 * np.abs(ref).max()
