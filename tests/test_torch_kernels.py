"""The port's kernel modules against their Pallas originals.

Each plain PyTorch version (what a kernel wrapper runs for a CPU tensor) is
held against the Pallas kernel run in interpret mode on the CPU, on the same
numpy inputs.  The CUDA kernels themselves run only on the card; their tests
are in `test_torch_cuda.py`, which imports no JAX so that it runs there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from gsoc_wav2vec2_tpu.ops.conv import init_weight_g as jax_init_weight_g
from gsoc_wav2vec2_tpu.ops.conv import weight_norm_kernel as jax_weight_norm_kernel
from gsoc_wav2vec2_tpu.ops.pallas import conv_frontend as jax_cf
from gsoc_wav2vec2_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused as jax_pos_conv
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend, flash_attention, pos_conv

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _frontend_inputs(length, c=128, seed=0):
    rng = np.random.default_rng(seed)
    wave = rng.standard_normal((2, length)).astype(np.float32)
    w0 = (rng.standard_normal((10, 1, c)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((3, c, c)) * 0.05).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return wave, w0, gamma, beta, w1


@pytest.mark.parametrize("length", [26000, 24003])
def test_window_stats_plain_matches_pallas(length):
    wave = np.random.default_rng(1).standard_normal((2, length)).astype(np.float32)
    t0 = conv_frontend.conv0_length(length)
    t1 = 1 + (t0 - 3) // 2
    # the Pallas call takes padded phase arrays; build them as fused_conv01 does
    tile = jax_cf.TILE
    r = -(-t1 // tile) * tile + tile
    xb = jnp.pad(jnp.asarray(wave).astype(jnp.bfloat16), ((0, 0), (0, 10 * r + 15 - length)))
    pa = xb[:, : 10 * r].reshape(2, r, 10)
    pb = xb[:, 5 : 5 + 10 * r].reshape(2, r, 10)
    want_gram, want_sum = jax_cf._window_stats(pa, pb, (t0 + 1) // 2, t0 // 2, True)

    gram, row_sum = conv_frontend.window_stats_plain(_t(wave).to(torch.bfloat16), t0)
    # rtol 1e-5 of each matrix's scale: both sides sum ~t0 products in f32,
    # in different orders, so entries near zero carry the large ones' noise
    for got, want in ((gram, want_gram), (row_sum, want_sum)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("length", [26000, 24000])
def test_fused_conv01_plain_matches_pallas(length):
    wave, w0, gamma, beta, w1 = _frontend_inputs(length)
    want = np.asarray(
        jax_cf.fused_conv01(*map(jnp.asarray, (wave, w0, gamma, beta, w1)),
                            gelu_approx=True, interpret=True),
        np.float32,
    )
    got = conv_frontend.fused_conv01(
        *map(_t, (wave, w0, gamma, beta, w1)), eps=1e-5, gelu_approx=True
    )
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    assert np.abs(got - want).mean() < 5e-3


@pytest.mark.parametrize("t", [256, 155])
def test_pos_conv_plain_matches_pallas(t):
    c, g, k = 256, 16, 128
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, t, c)) * 0.5).astype(np.float32)
    wv = (rng.standard_normal((k, c // g, c)) * 0.05).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wg = np.asarray(jax_init_weight_g(jnp.asarray(wv)))
    kernel = np.asarray(jax_weight_norm_kernel(jnp.asarray(wv), jnp.asarray(wg)))
    x_bf = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(
        jax_pos_conv(x_bf, jnp.asarray(kernel), jnp.asarray(bias), kernel_size=k,
                     groups=g, gelu_approx=True, interpret=True),
        np.float32,
    )
    got = pos_conv.pos_conv(
        _t(x).to(torch.bfloat16), _t(kernel), _t(bias), groups=g, gelu_approx=True
    ).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    assert np.abs(got - want).mean() < 5e-3


def _qkv(seed, b=2, h=4, l=256, d=64):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, l, d)) * 0.3).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("ragged", [False, True])
def test_flash_plain_matches_pallas(ragged):
    q, k, v = _qkv(3, l=200 if ragged else 256)
    b, l = q.shape[0], q.shape[2]
    bias = None
    if ragged:
        mask = np.ones((b, l), np.float32)
        mask[0, 100:] = 0.0
        mask[1, 170:] = 0.0
        bias = np.asarray(jax_mask_to_bias(jnp.asarray(mask)))  # (B, 1, 1, L)
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), interpret=True,
    ))
    out, lse = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias.reshape(b, l))
    )
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)
    assert lse.shape == (b, q.shape[1], l) and torch.isfinite(lse).all()


def test_flash_rejects_dropout():
    """Prob dropout is in the kernel now; only rates outside [0, 1) raise."""
    q, k, v = map(_t, _qkv(4, l=16))
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout rate"):
            flash_attention.flash_attention_fwd(q, k, v, dropout_rate=rate)
    out, _ = flash_attention.flash_attention_fwd(q, k, v, dropout_rate=0.1, seed=3)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("l", [200, 256])
def test_flash_dropout_plain_matches_pallas(l):
    """Dropout 0.3 with a ragged bias, same seed: the plain forward against
    the Pallas kernel in interpret mode (L = 200 hashes with the padded
    stride 256)."""
    q, k, v = _qkv(5, l=l)
    mask = np.ones((2, l), np.float32)
    mask[1, l // 3:] = 0.0
    bias = np.asarray(jax_mask_to_bias(jnp.asarray(mask)))
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), jnp.asarray(bias),
                                dropout_rate=0.3, dropout_seed=21, interpret=True))
    out, _ = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(bias.reshape(2, l)), dropout_rate=0.3, seed=21)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)
