"""The port's long-sequence path against the JAX package's long-sequence
kernels on the CPU.

Past 4096 frames the JAX package switches attention to its kv-blocked
kernels (`_fwd_blocked_kernel`, `_dq_blocked_kernel`,
`_dkv_blocked_kernel`) and, past 2048 frames, the positional conv to the
halo-tiled `pos_conv_blocked`.  The port has one kernel family for every
length, so its plain versions are held here against those JAX paths, engaged
at test-size lengths by lowering the thresholds inside the tests (as
tests/test_flash_attention.py does), in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsoc_wav2vec2_tpu.ops.pallas.flash_attention as jax_fa
from gsoc_wav2vec2_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from gsoc_wav2vec2_tpu.ops.conv import init_weight_g as jax_init_weight_g
from gsoc_wav2vec2_tpu.ops.conv import weight_norm_kernel as jax_weight_norm_kernel
from gsoc_wav2vec2_tpu.ops.pallas import pos_conv as jax_pc
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention, pos_conv

torch.set_num_threads(2)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


@pytest.fixture()
def blocked(monkeypatch):
    """Engage JAX's kv-blocked dispatch at test-size lengths (the real
    threshold is 4096 frames), with tiles small enough that a sequence spans
    several of both kinds."""
    monkeypatch.setattr(jax_fa, "WHOLE_KV_LIMIT", 128)
    monkeypatch.setattr(jax_fa, "BLOCKED_Q", 64)
    monkeypatch.setattr(jax_fa, "BLOCKED_KV", 128)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = jax_fa._flash_fwd_blocked, jax_fa._flash_bwd_blocked

    def counted_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(jax_fa, "_flash_fwd_blocked", counted_fwd)
    monkeypatch.setattr(jax_fa, "_flash_bwd_blocked", counted_bwd)
    return calls


def _qkv(seed, b, h, l, d=64):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, l, d)) * 0.3).astype(np.float32) for _ in range(3)]


def _ragged_bias(b, l):
    mask = np.ones((b, l), np.float32)
    mask[0, (2 * l) // 3:] = 0.0
    return np.asarray(jax_mask_to_bias(jnp.asarray(mask)))  # (B, 1, 1, L)


@pytest.mark.parametrize("l,rate", [(384, 0.0), (300, 0.0), (300, 0.3), (384, 0.3)])
def test_flash_fwd_plain_matches_jax_blocked(blocked, l, rate):
    """The plain forward against `_fwd_blocked_kernel` (online softmax over
    kv tiles, dropout on the unnormalised p), f32, atol 1e-4 as
    tests/test_flash_attention.py; L = 300 pads to 384, so the dropout hash
    runs with the padded row stride."""
    q, k, v = _qkv(1, 2, 2, l)
    bias = _ragged_bias(2, l)
    want = np.asarray(jax_fa.flash_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(bias), dropout_rate=rate, dropout_seed=21,
        interpret=True))
    assert blocked["fwd"] == 1
    out, lse = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(bias.reshape(2, l)), dropout_rate=rate, seed=21)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)
    assert lse.shape == (2, 2, l) and torch.isfinite(lse).all()


@pytest.mark.parametrize("l,rate", [(300, 0.0), (300, 0.2), (384, 0.2)])
def test_flash_grads_match_jax_blocked(blocked, l, rate):
    """`FlashAttention`'s plain backward against jax.grad through the
    kv-blocked dq and dk/dv kernels (delta from the saved output), atol 1e-3
    as tests/test_torch_train_ops.py holds the whole-K/V family."""
    q, k, v = _qkv(2, 1, 2, l)
    bias = _ragged_bias(1, l)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, jnp.asarray(bias), dropout_rate=rate,
                                   dropout_seed=9, interpret=True)
        return jnp.sum(o * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    assert blocked["fwd"] >= 1 and blocked["bwd"] == 1
    tq, tk, tv = (_t(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention.flash_attention(tq, tk, tv, _t(bias.reshape(1, l)),
                                          dropout_rate=rate, seed=9)
    (out * _t(w)).sum().backward()
    for got, ref, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,seed,row_offset,col_offset,row_stride", [
    ((64, 128), 11, 128, 256, 384),            # a (q tile, kv tile) of the blocked grid, L = 300
    ((16, 256), 2**23 - 1, 5984, 5760, 6016),  # the last rows of L = 5999 (stride 6016)
    ((8, 256), 123, 32760, 32512, 32768),      # the largest supported L: indices up to 2^30
    ((8, 128), 5, 65528, 65408, 65536),        # past 2^31: the uint32 index keeps its high bit
])
def test_dropout_mask_bit_equal_at_long_offsets(shape, seed, row_offset, col_offset, row_stride):
    """The keep mask's index row * stride + col is uint32 arithmetic: equal
    to JAX's bit for bit where it grows past 2^24 (not exact in f32), to
    2^30 at L = 32768, and past 2^31 (no signed saturation)."""
    for rate in (0.1, 0.3):
        want = np.asarray(jax_fa._dropout_mask(shape, rate, jnp.int32(seed), row_offset,
                                               col_offset, row_stride))
        got = flash_attention.dropout_mask(shape, rate, seed, row_offset, col_offset, row_stride)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0.5 * (1 - rate) < got.float().mean().item() < 1.0


def test_padded_length_is_the_hash_stride():
    assert [flash_attention.padded_length(l) for l in (128, 300, 5999, 8192, 32768)] == [
        128, 384, 6016, 8192, 32768]


def _pos_conv_inputs(t, c, g, k=128, seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, t, c)) * 0.5).astype(np.float32)
    wv = (rng.standard_normal((k, c // g, c)) * 0.05).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wg = np.asarray(jax_init_weight_g(jnp.asarray(wv)))
    kernel = np.asarray(jax_weight_norm_kernel(jnp.asarray(wv), jnp.asarray(wg)))
    return x, kernel, bias


def test_pos_conv_plain_matches_jax_blocked_past_max_t():
    """T = 2300 > MAX_T = 2048, where the JAX package tiles time with halos
    (`pos_conv_blocked`); the port's plain version takes the sequence whole.
    atol / rtol 0.05, mean 5e-3, as at the short lengths."""
    t, c, g, k = 2300, 64, 4, 128
    assert not jax_pc.supports_length(t)
    x, kernel, bias = _pos_conv_inputs(t, c, g, k)
    want = np.asarray(
        jax_pc.pos_conv_blocked(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(kernel),
                                jnp.asarray(bias), kernel_size=k, groups=g, gelu_approx=True,
                                interpret=True),
        np.float32,
    )
    got = pos_conv.pos_conv(_t(x).to(torch.bfloat16), _t(kernel), _t(bias), groups=g,
                            gelu_approx=True).float().numpy()
    assert got.shape == want.shape == (1, t, c)
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    assert np.abs(got - want).mean() < 5e-3


def test_pos_conv_train_grads_match_jax_blocked():
    """`PosConvTrain`'s gradients over one whole sequence against jax.grad
    through `pos_conv_blocked(training=True)` with several halo tiles
    (block_t = 128 at T = 330), at the tolerances of tests/test_pos_conv.py."""
    t, c, g, k = 330, 64, 4, 128
    x, kernel, bias = _pos_conv_inputs(t, c, g, k, seed=5)
    probe = np.random.default_rng(6).standard_normal((1, t, c)).astype(np.float32)

    def loss(x, kernel, bias):
        y = jax_pc.pos_conv_blocked(x.astype(jnp.bfloat16), kernel, bias, kernel_size=k, groups=g,
                                    gelu_approx=True, interpret=True, training=True, block_t=128)
        return jnp.sum(y.astype(jnp.float32) * probe)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, kernel, bias)))
    tx, tk, tb = (_t(a, requires_grad=True) for a in (x, kernel, bias))
    y = pos_conv.PosConvTrain.apply(tx.to(torch.bfloat16), tk, tb, g, True)
    (y.float() * _t(probe)).sum().backward()
    for got, ref in zip((tx, tk, tb), want):
        ref = np.asarray(ref, np.float32)
        diff = np.abs(got.grad.numpy() - ref)
        assert diff.mean() / (np.abs(ref).mean() + 1e-6) < 0.05
        assert diff.max() / (np.abs(ref).max() + 1e-6) < 0.2
