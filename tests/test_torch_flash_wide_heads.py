"""The flash kernels' head dims 192 and 256 against the JAX package on the CPU.

The port's plain forward and backward (what the wrappers run for a CPU
tensor) against JAX's `flash_attention` and its custom-VJP gradients with
the Pallas kernels in interpret mode, at (2, 2, L, D); a tiny base model
with 2 heads of 192 and a tiny robust model with 2 heads of 256 against the
JAX forward and stage-2 loss with `attention_impl="flash"` (Pallas in
interpret mode); the TMA layout the wrappers hand the kernels at D = 192
and 256; and the card's dispatch past 256.  Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import port_config_of
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from gsoc_wav2vec2_tpu.ops.pallas import flash_attention as jax_fa
from gsoc_wav2vec2_tpu.training import trainer as jax_trainer
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention
from gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention import _layout_ok, _strided_ok, tma_layout
from gsoc_wav2vec2_tpu_torch.training import state, trainer

torch.set_num_threads(2)
HEAD_DIMS = (192, 256)
SEQLEN = 8000
STAGE2 = ("feature_extractor",)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _qkv(seed, l, d, b=2, h=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, l, d)) * 0.3).astype(np.float32) for _ in range(3)]


def _ragged_bias(l):
    """JAX's (B, 1, 1, L) bias of a ragged mask: row 1 cut at L / 3."""
    mask = np.ones((2, l), np.float32)
    mask[1, l // 3:] = 0.0
    return np.asarray(jax_mask_to_bias(jnp.asarray(mask)))


# --- the forward and backward at D = 192 and 256 --------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_plain_matches_pallas_at_wide_heads(d, l, rate):
    """The plain forward against the Pallas kernel in interpret mode, ragged
    bias, dropout 0.3 under one seed (L = 200 hashes with the padded stride
    256), atol 1e-4 as at head dims 64 and 128."""
    q, k, v = _qkv(5 + d, l, d)
    bias = _ragged_bias(l)
    want = np.asarray(jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(bias),
                                             dropout_rate=rate, dropout_seed=21, interpret=True))
    out, lse = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(bias.reshape(2, l)), dropout_rate=rate, seed=21)
    assert out.shape == (2, 2, l, d) and lse.shape == (2, 2, l) and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_grads_match_pallas_at_wide_heads(d, l, rate):
    """`FlashAttention`'s plain backward against jax.grad through the Pallas
    kernels in interpret mode (the custom VJP), ragged bias, same dropout
    seed; atol 1e-3 of tests/test_flash_attention.py."""
    q, k, v = _qkv(6 + d, l, d)
    bias = _ragged_bias(l)
    w = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, jnp.asarray(bias), dropout_rate=rate,
                                   dropout_seed=13, interpret=True)
        return jnp.sum(o * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention.flash_attention(tq, tk, tv, _t(bias.reshape(2, l)),
                                          dropout_rate=rate, seed=13)
    (out * _t(w)).sum().backward()
    for got, ref, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-3, err_msg=f"d{name}")


# --- tiny models: base at 2 heads of 192, robust at 2 heads of 256 ------------------

# (robust, hidden size): 2 heads of hidden / 2
MODELS = {192: (False, 384), 256: (True, 512)}


def _pair(d, seed):
    """The tiny config of the family `MODELS` gives head dim `d` (2 layers,
    2 heads), JAX params loaded into the port's model."""
    robust, hidden = MODELS[d]
    cfg = tiny_config(robust=robust, hidden_size=hidden, num_heads=2, intermediate_size=2 * hidden)
    assert cfg.hidden_size // cfg.num_heads == d
    params = jax_modeling.init_wav2vec2_for_ctc_params(jax.random.PRNGKey(seed), cfg)
    pcfg = port_config_of(cfg)
    model = modeling.Wav2Vec2ForCTC(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, params, pcfg, model


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's `mha` with impl "flash" runs the Pallas kernels in interpret
    mode (it imports `flash_attention` from the module at each call)."""
    monkeypatch.setattr(jax_fa, "flash_attention",
                        functools.partial(jax_fa.flash_attention, interpret=True))


def _speech_and_mask(b=3, seed=2):
    speech = np.random.default_rng(seed).standard_normal((b, SEQLEN)).astype(np.float32)
    mask = np.zeros((b, SEQLEN), np.int64)
    for i, n in enumerate([SEQLEN, SEQLEN - 1700, SEQLEN - 3333][:b]):
        mask[i, :n] = 1
        speech[i, n:] = 0.0
    return speech, mask


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiny_model_at_wide_heads_matches_jax_flash(pallas_interpret, d):
    """Hidden states (atol 1e-3) and logits (atol 4e-3; the robust model with
    a ragged mask, the base family takes none) of the port on the CPU
    against the JAX forward through the Pallas flash kernels."""
    cfg, params, pcfg, model = _pair(d, 3)
    speech, mask = _speech_and_mask()
    mask = mask if cfg.is_robust else None
    jx = dict(attention_impl="flash")
    want_h = np.asarray(jax_modeling.wav2vec2_forward(params["wav2vec2"], cfg, jnp.asarray(speech),
                                                      **jx))
    want = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech), None if mask is None else jnp.asarray(mask), **jx))
    with torch.no_grad():
        got_h = modeling.wav2vec2_forward(model.wav2vec2, pcfg, torch.from_numpy(speech)).numpy()
        got = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(speech),
            None if mask is None else torch.from_numpy(mask)).numpy()
    assert got_h.shape == want_h.shape and got.shape == want.shape
    np.testing.assert_allclose(got_h, want_h, atol=1e-3)
    np.testing.assert_allclose(got, want, atol=4e-3)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiny_model_at_wide_heads_stage2_grads_match_jax_flash(pallas_interpret, d):
    """The stage-2 loss (rtol 1e-5) and gradients (atol 1e-4) against
    `jax.value_and_grad` through the Pallas flash kernels' custom VJP; the
    robust model with the mask and length-aware CTC, as
    tests/test_torch_flash_d128.py at head dim 128."""
    cfg, params, pcfg, model = _pair(d, 4)
    masked = cfg.is_robust
    rng = np.random.default_rng(0)
    labels = np.zeros((2, 10), np.int32)
    for i in range(2):
        n = rng.integers(3, 8)
        labels[i, :n] = rng.integers(1, 32, size=n)
    batch = {"speech": rng.standard_normal((2, SEQLEN)).astype(np.float32), "labels": labels}
    if masked:
        mask = np.ones((2, SEQLEN), np.int32)
        mask[1, 6000:] = 0
        batch["attention_mask"] = mask
    loss_fn = jax_trainer._make_ctc_loss_fn(
        cfg, division_factor=2.0, with_attention_mask=masked, length_aware=masked,
        compute_dtype=jnp.float32, remat=False, mesh=None, attention_impl="flash", frozen=STAGE2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.value_and_grad(loss_fn)(params, jb, jax.random.PRNGKey(0))
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    trainable = state.set_trainable(model, STAGE2)
    loss = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0, with_attention_mask=masked,
                                    length_aware=masked)(model, batch, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    attn = [n for n in trainable if "attention.q_proj" in n and trainable[n]]
    assert attn, "the attention projections train in stage 2"
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        if trainable[name]:
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        else:
            assert p.grad is None and not want.any(), name


# --- the TMA layout at D = 192 and 256 ---------------------------------------------


@pytest.mark.parametrize("b,h,l", [(16, 4, 768), (1, 4, 5999), (3, 2, 1)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_contiguous_heads_at_wide_heads_map_rows_then_heads(d, b, h, l):
    """Rows of 384 and 512 bytes: dims (D, L, H, B), the box 64 rows x 64
    columns (one 128-byte swizzle row; D / 64 boxes a row)."""
    x = torch.zeros(b, h, l, d, dtype=torch.bfloat16)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride())
    assert not heads_inner
    assert dims == [d, l, h, b]
    if l > 1:
        assert strides == [2 * d, l * 2 * d, h * l * 2 * d]
    assert box == [64, 64, 1, 1]
    assert _strided_ok(x) and _layout_ok(tuple(x.shape), x.stride())


@pytest.mark.parametrize("b,h,l", [(8, 4, 768), (1, 4, 5999), (2, 3, 65)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_projection_views_at_wide_heads_map_heads_then_rows(d, b, h, l):
    """The (B, L, H x D) projections' head views are read in place."""
    x = torch.zeros(b, l, h * d, dtype=torch.bfloat16).view(b, l, h, d).transpose(1, 2)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride())
    assert heads_inner
    assert dims == [d, h, l, b]
    assert strides == [2 * d, h * 2 * d, l * h * 2 * d]
    assert box == [64, 1, 64, 1]
    assert _strided_ok(x)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_wide_head_views_that_break_tma_rules_are_refused(d):
    """Rows D + 4 elements apart (not a 16-byte multiple) and overlapping
    heads are refused, rows D + 8 apart are read in place."""
    assert not _strided_ok(torch.zeros(2, 3, 40, d + 4, dtype=torch.bfloat16)[..., :d])
    assert _strided_ok(torch.zeros(2, 3, 40, d + 8, dtype=torch.bfloat16)[..., :d])
    assert not _strided_ok(torch.zeros(2, 1, 40, d, dtype=torch.bfloat16).expand(2, 3, 40, d))


# --- the card's dispatch past 256 ---------------------------------------------------


@pytest.mark.parametrize("d", [320, 384, 512])
def test_flash_refuses_head_dims_past_256(d):
    """JAX's kernel takes every multiple of 64; the port's instances stop at
    256 by design (from 320 the output accumulator alone is 160 f32
    registers a consumer thread), so wider heads run the plain attention on
    the card and the kernels' layout check refuses them."""
    assert not flash_attention.supports(d, torch.bfloat16)
    assert not _layout_ok((2, 3, 40, d), torch.zeros(2, 3, 40, d).stride())
    x = torch.zeros(1, 1, 8, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention._check("flash_attention_fwd", x, x, x, None)
