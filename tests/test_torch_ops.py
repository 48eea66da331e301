"""The port's op layer against the JAX ops, on the same numpy inputs, f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu.ops import attention as jax_attention
from gsoc_wav2vec2_tpu.ops import basic as jax_basic
from gsoc_wav2vec2_tpu.ops import conv as jax_conv
from gsoc_wav2vec2_tpu_torch.ops import attention, basic, conv

torch.set_num_threads(2)
ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_f32_matches_jax(approximate):
    x = _rng().standard_normal((4, 33)).astype(np.float32) * 3
    want = np.asarray(jax_basic.gelu(jnp.asarray(x), approximate=approximate))
    got = basic.gelu(_t(x), approximate=approximate).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gelu_bf16_takes_the_tanh_form():
    """Exact GELU in bf16 becomes tanh GELU on both sides."""
    x = _rng(1).standard_normal((4, 33)).astype(np.float32) * 3
    want = np.asarray(jax_basic.gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = basic.gelu(_t(x).to(torch.bfloat16)).float().numpy()
    tanh_f32 = basic.gelu(_t(x), approximate=True).numpy()
    # bf16 resolution: one ulp of |y| <= 10 is 2^-4
    np.testing.assert_allclose(got, want, atol=2 ** -4, rtol=2 ** -7)
    np.testing.assert_allclose(got, tanh_f32, atol=2 ** -4, rtol=2 ** -7)


def test_dense_matches_jax():
    r = _rng(2)
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    k = r.standard_normal((16, 8)).astype(np.float32)
    b = r.standard_normal(8).astype(np.float32)
    want = np.asarray(jax_basic.dense(jnp.asarray(x), {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}))
    np.testing.assert_allclose(basic.dense(_t(x), _t(k), _t(b)).numpy(), want, atol=ATOL)


def test_layer_norm_matches_jax():
    r = _rng(3)
    x = (r.standard_normal((2, 7, 32)) * 2 + 1).astype(np.float32)
    g = r.standard_normal(32).astype(np.float32)
    b = r.standard_normal(32).astype(np.float32)
    want = np.asarray(jax_basic.layer_norm(jnp.asarray(x), {"gamma": jnp.asarray(g), "beta": jnp.asarray(b)}))
    np.testing.assert_allclose(basic.layer_norm(_t(x), _t(g), _t(b)).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("groups", [32, 4])
def test_group_norm_matches_jax(groups):
    r = _rng(4)
    x = (r.standard_normal((2, 50, 32)) * 2 + 0.5).astype(np.float32)
    g = r.standard_normal(32).astype(np.float32)
    b = r.standard_normal(32).astype(np.float32)
    want = np.asarray(jax_basic.group_norm(
        jnp.asarray(x), {"gamma": jnp.asarray(g), "beta": jnp.asarray(b)}, groups=groups))
    got = basic.group_norm(_t(x), _t(g), _t(b), groups=groups).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("stride,padding,groups", [(5, 0, 1), (2, 0, 1), (1, 4, 4)])
def test_conv1d_matches_jax(stride, padding, groups):
    r = _rng(5)
    x = r.standard_normal((2, 41, 8)).astype(np.float32)
    k = (r.standard_normal((3 if padding == 0 else 8, 8 // groups, 12)) * 0.3).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    want = np.asarray(jax_conv.conv1d(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=stride,
        padding=((padding, padding),), groups=groups))
    got = conv.conv1d(_t(x), _t(k), _t(b), stride=stride, padding=padding, groups=groups).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_weight_norm_kernel_matches_jax():
    r = _rng(6)
    v = r.standard_normal((16, 4, 64)).astype(np.float32)
    g = np.abs(r.standard_normal((16, 1, 1))).astype(np.float32)
    want = np.asarray(jax_conv.weight_norm_kernel(jnp.asarray(v), jnp.asarray(g)))
    np.testing.assert_allclose(conv.weight_norm_kernel(_t(v), _t(g)).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        conv.init_weight_g(_t(v)).numpy(), np.asarray(jax_conv.init_weight_g(jnp.asarray(v))),
        rtol=1e-6)


def test_pos_conv_embed_matches_jax():
    """The pos-conv dispatch (pad K/2, crop the trailing frame, GELU) on the
    CPU path, against the JAX XLA path."""
    r = _rng(7)
    x = (r.standard_normal((2, 40, 64)) * 0.5).astype(np.float32)
    v = (r.standard_normal((16, 4, 64)) * 0.1).astype(np.float32)
    g = np.asarray(jax_conv.init_weight_g(jnp.asarray(v)))
    b = (0.1 * r.standard_normal(64)).astype(np.float32)
    want = np.asarray(jax_conv.pos_conv_embed(
        jnp.asarray(x), {"weight_v": jnp.asarray(v), "weight_g": jnp.asarray(g), "bias": jnp.asarray(b)},
        16, 16))
    got = conv.pos_conv_embed(_t(x), _t(v), _t(g), _t(b), 16, 16).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mask_to_bias_matches_jax():
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], bool)
    want = np.asarray(jax_attention.mask_to_bias(jnp.asarray(mask)))
    got = attention.mask_to_bias(_t(mask)).numpy()
    assert got.shape == (2, 1, 1, 4)
    np.testing.assert_array_equal(got, want)


def _attn_params(h, r):
    class P:  # attribute access like the port's Attention module
        pass

    jp, tp = {}, P()
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        k = (r.standard_normal((h, h)) * 0.2).astype(np.float32)
        b = (r.standard_normal(h) * 0.1).astype(np.float32)
        jp[name] = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
        d = P()
        d.kernel, d.bias = _t(k), _t(b)
        setattr(tp, name, d)
    return jp, tp


@pytest.mark.parametrize("port_mha", [attention.mha_plain, attention.mha], ids=["plain", "flash"])
def test_mha_matches_jax_xla(port_mha):
    r = _rng(8)
    h, heads = 64, 4
    x = r.standard_normal((2, 30, h)).astype(np.float32)
    jp, tp = _attn_params(h, r)
    mask = np.ones((2, 30), bool)
    mask[1, 20:] = False
    jb = jax_attention.mask_to_bias(jnp.asarray(mask))
    want = np.asarray(jax_attention.mha_xla(jnp.asarray(x), jp, heads, jb))
    got = port_mha(_t(x), tp, heads, attention.mask_to_bias(_t(mask))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
