"""The port's training ops against the JAX package on the CPU.

Dropout masks bit for bit (the same seed words on both sides), the
`FlashAttention` / `PosConvTrain` gradients against the Pallas kernels in
interpret mode, the CTC loss per sample, and SpecAugment's mask contract.
(The flash forward with dropout is held against Pallas in
`test_torch_kernels.py`.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu.ops import basic as jax_basic
from gsoc_wav2vec2_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from gsoc_wav2vec2_tpu.ops.conv import init_weight_g as jax_init_weight_g
from gsoc_wav2vec2_tpu.ops.conv import weight_norm_kernel as jax_weight_norm_kernel
from gsoc_wav2vec2_tpu.ops.ctc import CTCLoss as JaxCTCLoss
from gsoc_wav2vec2_tpu.ops.ctc import ctc_loss_fn as jax_ctc_loss_fn
from gsoc_wav2vec2_tpu.ops.pallas import flash_attention as jax_fa
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused_train as jax_pos_conv_train
from gsoc_wav2vec2_tpu_torch.models.config import Wav2Vec2Config
from gsoc_wav2vec2_tpu_torch.ops import basic, ctc, specaugment
from gsoc_wav2vec2_tpu_torch.ops.conv import weight_norm_kernel
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention, pos_conv

torch.set_num_threads(2)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


# --- dropout masks ------------------------------------------------------------


@pytest.mark.parametrize("shape,words,rate", [
    ((4, 37, 16), (0, 0), 0.1),
    ((3, 50), (2**32 - 1, 12345), 0.5),
    ((2, 8, 3, 33), (987654321, 2**31 + 7), 0.3),
])
def test_hash_keep_mask_bit_equal_to_jax(shape, words, rate):
    seed = jnp.asarray(np.array(words, np.uint32))
    want = np.asarray(jax_basic._hash_keep_mask(seed, shape, rate))
    got = basic._hash_keep_mask(words, shape, rate).numpy()
    np.testing.assert_array_equal(got, want)


def test_dropout_matches_jax_for_the_same_words():
    x = np.random.default_rng(0).standard_normal((2, 20, 24)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    words = tuple(int(w) for w in np.asarray(jax.random.bits(rng, (2,), jnp.uint32)))
    want = np.asarray(jax_basic.dropout(jnp.asarray(x), 0.1, rng, deterministic=False))
    got = basic.dropout(_t(x), 0.1, words, deterministic=False).numpy()
    np.testing.assert_array_equal(got, want)
    # eval, or rate 0: the identity
    np.testing.assert_array_equal(basic.dropout(_t(x), 0.1, None, True).numpy(), x)
    np.testing.assert_array_equal(basic.dropout(_t(x), 0.0, words, False).numpy(), x)


def test_stochastic_depth_eval_is_the_plain_sum():
    r, b = torch.ones(2, 3), torch.full((2, 3), 2.0)
    assert torch.equal(basic.stochastic_depth(r, b, 0.5, None, deterministic=True), r + b)
    assert torch.equal(basic.stochastic_depth(r, b, 0.5, True, deterministic=False), r + b)
    assert torch.equal(basic.stochastic_depth(r, b, 0.5, False, deterministic=False), r)


@pytest.mark.parametrize("shape,seed,row_offset,col_offset,row_stride", [
    ((64, 256), 5, 0, 0, None),
    ((40, 128), 2**23 - 1, 100, 7, 1280),
    ((256, 256), 77, 256, 0, 1024),
    ((16, 200), 0, 3, 0, 256),
])
def test_flash_dropout_mask_bit_equal_to_jax(shape, seed, row_offset, col_offset, row_stride):
    for rate in (0.1, 0.3):
        want = np.asarray(jax_fa._dropout_mask(shape, rate, jnp.int32(seed), row_offset,
                                               col_offset, row_stride))
        got = flash_attention.dropout_mask(shape, rate, seed, row_offset, col_offset, row_stride)
        np.testing.assert_array_equal(got.numpy(), want)


# --- flash attention with dropout, forward and gradients --------------------


def _qkv(seed, b=2, h=3, l=256, d=16):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, l, d)) * 0.3).astype(np.float32) for _ in range(3)]


def _ragged_bias(b, l):
    mask = np.ones((b, l), np.float32)
    mask[0, l // 2:] = 0.0
    return np.asarray(jax_mask_to_bias(jnp.asarray(mask)))  # (B, 1, 1, L)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_attention_grads_match_jax(rate):
    """FlashAttention's plain backward against jax.grad through the Pallas
    kernel in interpret mode (atol of tests/test_flash_attention.py)."""
    q, k, v = _qkv(4, b=1, h=2, l=200)
    bias = _ragged_bias(1, 200)
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, jnp.asarray(bias), dropout_rate=rate,
                                   dropout_seed=9, interpret=True)
        return jnp.sum(o * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention.flash_attention(tq, tk, tv, _t(bias.reshape(1, 200)),
                                          dropout_rate=rate, seed=9)
    (out * _t(w)).sum().backward()
    for got, ref, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-3, err_msg=f"d{name}")


def test_flash_bwd_plain_delta_matches_p_dp():
    """The backward's softmax correction from sum(dout * out) equals JAX's
    sum(p * dp), dropout included: the plain backward agrees with autograd
    through the plain forward."""
    q, k, v = (_t(a, requires_grad=True) for a in _qkv(6, l=130))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    out = flash_attention.flash_attention(q, k, v, None, dropout_rate=0.25, seed=4)
    got = torch.autograd.grad(out, (q, k, v), dout)
    qa, ka, va = (a.detach().clone().requires_grad_() for a in (q, k, v))
    s = qa @ ka.transpose(-1, -2)
    p = torch.softmax(s, -1)
    keep = flash_attention.dropout_mask((130, 130), 0.25, flash_attention._head_seeds(4, 2, 3, None),
                                        row_stride=256)
    ref = torch.where(keep, p / 0.75, torch.zeros_like(p)) @ va
    want = torch.autograd.grad(ref, (qa, ka, va), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# --- positional conv: PosConvTrain ------------------------------------------


def test_pos_conv_train_grads_match_pallas():
    """x, weight_v, weight_g and bias grads of PosConvTrain (bf16 x, plain
    kernels on the CPU) against jax.grad through `pos_conv_fused_train` in
    interpret mode, at the tolerances of tests/test_pos_conv.py."""
    g, k, t, c = 16, 128, 256, 256
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, t, c)) * 0.5).astype(np.float32)
    wv = (rng.standard_normal((k, c // g, c)) * 0.05).astype(np.float32)
    wg = np.asarray(jax_init_weight_g(jnp.asarray(wv)))
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    probe = rng.standard_normal((2, t, c)).astype(np.float32)

    def loss(params, x):
        kernel = jax_weight_norm_kernel(params["weight_v"], params["weight_g"])
        y = jax_pos_conv_train(x.astype(jnp.bfloat16), kernel, params["bias"], kernel_size=k,
                               groups=g, gelu_approx=True, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * probe)

    params = {"weight_v": jnp.asarray(wv), "weight_g": jnp.asarray(wg), "bias": jnp.asarray(bias)}
    want_p, want_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tx, tv, tg, tb = (_t(a, requires_grad=True) for a in (x, wv, wg, bias))
    y = pos_conv.PosConvTrain.apply(tx.to(torch.bfloat16), weight_norm_kernel(tv, tg), tb, g, True)
    (y.float() * _t(probe)).sum().backward()
    for got, want in ((tx, want_x), (tv, want_p["weight_v"]), (tg, want_p["weight_g"]),
                      (tb, want_p["bias"])):
        want = np.asarray(want, np.float32)
        diff = np.abs(got.grad.numpy() - want)
        assert diff.mean() / (np.abs(want).mean() + 1e-6) < 0.05
        assert diff.max() / (np.abs(want).max() + 1e-6) < 0.2


def test_pos_conv_train_forward_matches_inference():
    """The train forward's output is the inference forward's, and its
    pre-activation is GELU's input."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 40, 64)).astype(np.float32))
    kernel = _t((rng.standard_normal((128, 4, 64)) * 0.05).astype(np.float32))
    bias = _t(rng.standard_normal(64).astype(np.float32))
    y, pre = pos_conv.pos_conv_train_fwd(x, kernel, bias, groups=16, gelu_approx=False)
    torch.testing.assert_close(y, pos_conv.pos_conv(x, kernel, bias, groups=16, gelu_approx=False),
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.nn.functional.gelu(pre), y, rtol=0, atol=0)


# --- CTC loss -----------------------------------------------------------------


def _ctc_case(seed, b=4, t=50, v=32):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, v)).astype(np.float32)
    labels = np.zeros((b, 16), np.int32)
    for i, n in enumerate(rng.integers(3, 12, size=b)):
        labels[i, :n] = rng.integers(1, v, size=n)
    return logits, labels


@pytest.mark.parametrize("lengths", [None, [50, 37, 44, 29]])
def test_ctc_loss_fn_matches_jax(lengths):
    logits, labels = _ctc_case(0)
    lengths = np.full(4, 50, np.int32) if lengths is None else np.asarray(lengths, np.int32)
    want = np.asarray(jax_ctc_loss_fn(*map(jnp.asarray, (logits, labels, lengths)), 0))
    got = ctc.ctc_loss_fn(_t(logits), _t(labels), _t(lengths), 0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("length_aware", [False, True])
def test_ctc_loss_class_matches_jax(length_aware):
    """Constant logit length (padding frames counted) and length-aware."""
    cfg = Wav2Vec2Config()
    audio = 16000
    t = cfg.conv_output_length(audio)
    logits, labels = _ctc_case(1, b=3, t=t)
    mask = np.ones((3, audio), np.int32)
    mask[1, 12000:] = 0
    mask[2, 9000:] = 0
    from gsoc_wav2vec2_tpu.models.config import Wav2Vec2Config as JaxConfig

    want = JaxCTCLoss(JaxConfig(), (3, audio), division_factor=3, length_aware=length_aware)(
        jnp.asarray(labels), jnp.asarray(logits), jnp.asarray(mask))
    got = ctc.CTCLoss(cfg, (3, audio), division_factor=3, length_aware=length_aware)(
        _t(labels), _t(logits), _t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)


def test_ctc_loss_gradient_is_softmax_minus_posterior():
    """Autograd through log_softmax + F.ctc_loss: per frame the logit
    gradient sums to 0 (softmax minus a distribution); frames past the
    logit length get none."""
    logits, labels = _ctc_case(2)
    x = _t(logits, requires_grad=True)
    lengths = torch.tensor([50, 40, 30, 20])
    ctc.ctc_loss_fn(x, _t(labels), lengths).sum().backward()
    sums = x.grad.sum(-1)
    torch.testing.assert_close(sums, torch.zeros_like(sums), atol=1e-5, rtol=0)
    assert x.grad[3, 20:].abs().max() == 0


# --- SpecAugment --------------------------------------------------------------


@pytest.mark.parametrize("seqlen,prob,length,min_masks", [(100, 0.05, 10, 2), (300, 0.3, 7, 2),
                                                          (64, 0.5, 4, 0)])
def test_spec_augment_mask_spans(seqlen, prob, length, min_masks):
    """Per sample: between max(min_masks, ...) and the static bound of
    spans, each of `length` frames, inside the sequence."""
    gen = torch.Generator().manual_seed(0)
    b = 16
    mask = specaugment.compute_mask_indices(gen, b, seqlen, prob, length, min_masks)
    assert mask.shape == (b, seqlen) and mask.dtype == torch.bool
    base = prob * seqlen / length
    max_spans = min(max(int(base) + 1, min_masks), seqlen // length)
    lo = min(max(int(base), min_masks), max_spans)
    counts = mask.sum(-1)
    assert (counts <= max_spans * length).all()
    # spans may overlap, so the masked count is at least one span when any
    if lo > 0:
        assert (counts >= length).all()
    # every run of masked frames is a union of whole spans: at least `length` long
    m = mask.to(torch.int8)
    edges = torch.diff(torch.nn.functional.pad(m, (1, 1)), dim=-1)
    starts = [torch.nonzero(e == 1).flatten() for e in edges]
    ends = [torch.nonzero(e == -1).flatten() for e in edges]
    for s, e in zip(starts, ends):
        assert ((e - s) >= length).all()


def test_spec_augmentation_fills_the_embedding():
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(4, 120, 8)
    embed = torch.arange(8, dtype=torch.float32)
    out = specaugment.apply_spec_augmentation(gen, feats, embed, 0.2, 10)
    masked = (out == embed).all(-1)
    assert masked.any(-1).all()
    torch.testing.assert_close(out[~masked], feats[~masked], rtol=0, atol=0)
    # the same generator state draws the same mask
    again = specaugment.apply_spec_augmentation(torch.Generator().manual_seed(1), feats, embed,
                                                0.2, 10)
    assert torch.equal(out, again)
    zeroed = specaugment.apply_feature_masking(torch.Generator().manual_seed(2), feats, 0.5, 2, 1)
    cols = (zeroed == 0).all(dim=1)  # (B, H): hidden dims zeroed at every step
    assert cols.any(-1).all()
