"""The flash kernels' f32 instance (head dim 64) against the JAX package on the CPU.

`--compute_dtype float32` has the JAX package run its dtype-generic Pallas
flash kernels on f32 inputs; the port runs `csrc/flash_attention_f32.cu`
there.  On the CPU the wrappers run their plain versions, which compute in
f32 and round nothing: held here against JAX's `flash_attention` and its
custom-VJP gradients with the Pallas kernels in interpret mode, in f32, at
(2, 2, L, 64); tiny base and robust models with heads of 64 in f32 against
the JAX forward and stage-2 gradients through the Pallas kernels; the TMA
layout of f32 views (32-column boxes, byte strides); and the card's
dispatch by head dim and dtype.  Inputs come from numpy seeds.
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
from gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention import (
    _check, _dense, _layout_ok, _strided_ok, tma_layout)
from gsoc_wav2vec2_tpu_torch.training import state, trainer

torch.set_num_threads(2)
D = 64
SEQLEN = 8000


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _qkv(seed, l, b=2, h=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, l, D)) * 0.3).astype(np.float32) for _ in range(3)]


def _ragged_bias(l):
    """JAX's (B, 1, 1, L) bias of a ragged mask: row 1 cut at L / 3."""
    mask = np.ones((2, l), np.float32)
    mask[1, l // 3:] = 0.0
    return np.asarray(jax_mask_to_bias(jnp.asarray(mask)))


# --- the forward and backward in f32 ------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
def test_flash_f32_plain_matches_pallas(l, rate):
    """The plain forward against the Pallas kernel in interpret mode on f32
    inputs (p kept in f32 by both), ragged bias, dropout 0.3 under one seed
    (L = 200 hashes with the padded stride 256): atol 1e-5, f32 sums in
    another order."""
    q, k, v = _qkv(5, l)
    bias = _ragged_bias(l)
    want = np.asarray(jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(bias),
                                             dropout_rate=rate, dropout_seed=21, interpret=True))
    assert want.dtype == np.float32
    out, lse = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(bias.reshape(2, l)), dropout_rate=rate, seed=21)
    assert out.dtype == torch.float32 and out.shape == (2, 2, l, D) and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
def test_flash_f32_grads_match_pallas(l, rate):
    """`FlashAttention`'s plain backward against jax.grad through the Pallas
    kernels in interpret mode (the custom VJP) on f32 inputs, ragged bias,
    same dropout seed: atol 1e-4 (ds and the dropped p in f32 on both
    sides; sums in another order)."""
    q, k, v = _qkv(6, l)
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
        assert got.grad.dtype == torch.float32
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-4, err_msg=f"d{name}")


# --- tiny base and robust models with heads of 64, in f32 -------------------------


def _pair(robust, seed):
    """A tiny config with 2 heads of 64 (2 layers), JAX params loaded into
    the port's model."""
    cfg = tiny_config(robust=robust, hidden_size=128, num_heads=2, intermediate_size=256)
    assert cfg.hidden_size // cfg.num_heads == D
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


@pytest.mark.parametrize("robust", [False, True])
def test_tiny_model_f32_hidden_states_match_jax_flash(pallas_interpret, robust):
    """Hidden states of the port's f32 forward (with the robust family's
    ragged mask) against the JAX f32 forward through the Pallas flash
    kernels: atol 1e-4."""
    cfg, params, pcfg, model = _pair(robust, 31 + robust)
    speech, mask = _speech_and_mask()
    m = mask if robust else None
    want = np.asarray(jax_modeling.wav2vec2_forward(
        params["wav2vec2"], cfg, jnp.asarray(speech), None if m is None else jnp.asarray(m),
        compute_dtype=jnp.float32, attention_impl="flash"))
    with torch.no_grad():
        got = modeling.wav2vec2_forward(model.wav2vec2, pcfg, torch.from_numpy(speech),
                                        None if m is None else torch.from_numpy(m),
                                        compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


STAGE2 = ("feature_extractor",)


@pytest.mark.parametrize("robust", [False, True])
def test_tiny_model_f32_stage2_grads_match_jax_flash(pallas_interpret, robust):
    """The f32 stage-2 loss (rtol 1e-5) and gradients (atol 1e-4, as
    tests/test_torch_xlarge.py holds f32) against `jax.value_and_grad`
    through the Pallas flash kernels' custom VJP; the robust family with its
    mask and length-aware CTC."""
    cfg, params, pcfg, model = _pair(robust, 41 + robust)
    rng = np.random.default_rng(0)
    labels = np.zeros((2, 10), np.int32)
    for i in range(2):
        n = rng.integers(3, 8)
        labels[i, :n] = rng.integers(1, 32, size=n)
    batch = {"speech": rng.standard_normal((2, SEQLEN)).astype(np.float32), "labels": labels}
    if robust:
        mask = np.ones((2, SEQLEN), np.int32)
        mask[1, 6000:] = 0
        batch["attention_mask"] = mask
    loss_fn = jax_trainer._make_ctc_loss_fn(
        cfg, division_factor=2.0, with_attention_mask=robust, length_aware=robust,
        compute_dtype=jnp.float32, remat=False, mesh=None, attention_impl="flash", frozen=STAGE2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.value_and_grad(loss_fn)(params, jb, jax.random.PRNGKey(0))
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    trainable = state.set_trainable(model, STAGE2)
    loss = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0, with_attention_mask=robust,
                                    length_aware=robust, compute_dtype=torch.float32)(
        model, batch, torch.Generator().manual_seed(0))
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


# --- the TMA layout of f32 views ---------------------------------------------------


def _proj_view(b, l, h, dtype=torch.float32):
    """The head split of a (B, L, H*64) projection, as `split_heads` gives it."""
    return torch.zeros(b, l, h * D, dtype=dtype).view(b, l, h, D).transpose(1, 2)


@pytest.mark.parametrize("b,h,l", [(16, 12, 768), (8, 16, 768), (1, 12, 5999), (3, 2, 1)])
def test_f32_contiguous_heads_map_rows_then_heads(b, h, l):
    """Rows of 64 f32 are 256 bytes: dims (64, L, H, B), the box 64 rows x
    32 columns (one 128-byte swizzle row; two boxes a row)."""
    x = torch.zeros(b, h, l, D)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride(), x.element_size())
    assert not heads_inner
    assert dims == [D, l, h, b]
    if l > 1:
        assert strides == [256, l * 256, h * l * 256]
    assert box == [32, 64, 1, 1]
    assert _strided_ok(x) and _layout_ok(tuple(x.shape), x.stride(), 4)


@pytest.mark.parametrize("b,h,l", [(16, 12, 768), (8, 16, 768), (1, 12, 5999), (2, 3, 65)])
def test_f32_projection_views_map_heads_then_rows(b, h, l):
    """The (B, L, H x 64) f32 projections' head views are read in place."""
    x = _proj_view(b, l, h)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride(), 4)
    assert heads_inner
    assert dims == [D, h, l, b]
    assert strides == [256, h * 256, l * h * 256]
    assert box == [32, 1, 64, 1]
    assert _strided_ok(x)


@pytest.mark.parametrize("case", ["misaligned", "row_stride_66", "overlapping", "row_major_d"])
def test_f32_views_that_break_tma_rules_are_refused_and_copied(case):
    """A base 4 bytes past a 16-byte boundary, rows 66 f32 apart (264 bytes,
    not a 16-byte multiple: a row stride that bf16 would take as 132 bytes
    neither), heads overlapping, and D not innermost: refused, and `_dense`
    copies them into a layout TMA reads."""
    base = torch.arange(2 * 3 * 40 * D, dtype=torch.float32)
    if case == "misaligned":
        x = torch.empty(base.numel() + 4)[1:1 + base.numel()].view(2, 3, 40, D)
        x.copy_(base.view(2, 3, 40, D))
        assert x.data_ptr() % 16
    elif case == "row_stride_66":
        x = torch.zeros(2, 3, 40, 66)[..., :D]
    elif case == "overlapping":
        x = torch.zeros(2, 1, 40, D).expand(2, 3, 40, D)
    else:
        x = torch.zeros(2, 3, D, 40).transpose(2, 3)
    assert not _strided_ok(x)
    y = _dense(x)
    assert _strided_ok(y) and y.is_contiguous() and torch.equal(y, x)


def test_f32_rows_68_apart_are_read_in_place():
    """Rows 68 f32 apart (272 bytes) are a 16-byte multiple: read in place."""
    x = torch.zeros(2, 3, 40, 68)[..., :D]
    assert _strided_ok(x)
    assert tma_layout(x.shape, x.stride(), 4)[1] == [272, 40 * 272, 3 * 40 * 272]


def test_check_takes_f32_and_refuses_mixed_dtypes_and_other_head_dims():
    """`_check` keeps f32 projection views as they are; q, k, v of mixed
    dtypes, f32 at a head dim without an f32 instance (320), and dtypes
    without any instance raise."""
    q, k, v = (_proj_view(2, 50, 4) for _ in range(3))
    qq, kk, vv, bias = _check("t", q, k, v, torch.zeros(2, 50))
    assert qq is q and kk is k and vv is v and bias.dtype == torch.float32
    with pytest.raises(ValueError, match="one dtype"):
        _check("t", q, k.bfloat16(), v, None)
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(2, 4, 50, 320)
        _check("t", x, x, x, None)
    with pytest.raises(ValueError, match="one dtype"):
        x = torch.zeros(2, 4, 50, D, dtype=torch.float16)
        _check("t", x, x, x, None)


# --- the card's dispatch ---------------------------------------------------------


def test_flash_supports_f32_at_head_dim_64_only():
    """f32 takes the kernels at head dim 64 (base, large, large-robust and
    XLSR-53 heads), and at 128, 192 and 256 (`csrc/flash_attention_f32_wide.cu`);
    80, 120 and 320 run the plain attention in f32; bf16 is as it was."""
    for d in (64, 128, 192, 256):
        assert flash_attention.supports(d, torch.float32), d
    for d in (80, 120, 320):
        assert not flash_attention.supports(d, torch.float32), d
    for d in (64, 128, 192, 256):
        assert flash_attention.supports(d, torch.bfloat16), d
    for d in (80, 120, 320):
        assert not flash_attention.supports(d, torch.bfloat16), d
    for dtype in (torch.float16, torch.float64):
        assert not flash_attention.supports(64, dtype), dtype
