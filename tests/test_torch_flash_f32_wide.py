"""The flash kernels' f32 instances at head dims 128, 192 and 256 against the JAX package on the CPU.

`--compute_dtype float32` has the JAX package run its dtype-generic Pallas
flash kernels on f32 inputs at every head dim its dispatch takes; the port
runs `csrc/flash_attention_f32_wide.cu` at 128, 192 and 256.  On the CPU
the wrappers run their plain versions, which compute in f32 and round
nothing: held here against JAX's `flash_attention` and its custom-VJP
gradients with the Pallas kernels in interpret mode, in f32, at (2, 2, L,
D); a tiny robust model with heads of 128 and tiny base models with heads of
192 and 256, in f32, against the JAX forward and stage-2 gradients through
the Pallas kernels; the kernels' three-TF32 products emulated against f64;
the TMA layout of f32 views at 4, 6 and 8 boxes a row (32-row boxes); and
the card's dispatch by head dim and dtype.  Inputs come from numpy seeds.
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
HEAD_DIMS = (128, 192, 256)
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


# --- the forward and backward in f32 ------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_f32_plain_matches_pallas_at_wide_heads(d, l, rate):
    """The plain forward against the Pallas kernel in interpret mode on f32
    inputs (p kept in f32 by both), ragged bias, dropout 0.3 under one seed
    (L = 200 hashes with the padded stride 256): atol 1e-5, f32 sums in
    another order."""
    q, k, v = _qkv(5 + d, l, d)
    bias = _ragged_bias(l)
    want = np.asarray(jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(bias),
                                             dropout_rate=rate, dropout_seed=21, interpret=True))
    assert want.dtype == np.float32
    out, lse = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(bias.reshape(2, l)), dropout_rate=rate, seed=21)
    assert out.dtype == torch.float32 and out.shape == (2, 2, l, d) and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_f32_grads_match_pallas_at_wide_heads(d, l, rate):
    """`FlashAttention`'s plain backward against jax.grad through the Pallas
    kernels in interpret mode (the custom VJP) on f32 inputs, ragged bias,
    same dropout seed: atol 1e-4 (ds and the dropped p in f32 on both
    sides; sums in another order)."""
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
        assert got.grad.dtype == torch.float32
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-4, err_msg=f"d{name}")


# --- tiny models: robust at 2 heads of 128, base at 2 heads of 192 and 256, f32 ------

# head dim -> (robust, hidden size): 2 heads of hidden / 2
MODELS = {128: (True, 256), 192: (False, 384), 256: (False, 512)}


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
def test_tiny_model_f32_hidden_states_match_jax_flash_at_wide_heads(pallas_interpret, d):
    """Hidden states of the port's f32 forward (the robust model with a
    ragged mask) against the JAX f32 forward through the Pallas flash
    kernels: atol 1e-4."""
    cfg, params, pcfg, model = _pair(d, 51 + d)
    speech, mask = _speech_and_mask()
    m = mask if cfg.is_robust else None
    want = np.asarray(jax_modeling.wav2vec2_forward(
        params["wav2vec2"], cfg, jnp.asarray(speech), None if m is None else jnp.asarray(m),
        compute_dtype=jnp.float32, attention_impl="flash"))
    with torch.no_grad():
        got = modeling.wav2vec2_forward(model.wav2vec2, pcfg, torch.from_numpy(speech),
                                        None if m is None else torch.from_numpy(m),
                                        compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiny_model_f32_stage2_grads_match_jax_flash_at_wide_heads(pallas_interpret, d):
    """The f32 stage-2 loss (rtol 1e-5) and gradients (atol 1e-4) against
    `jax.value_and_grad` through the Pallas flash kernels' custom VJP; the
    robust model with its mask and length-aware CTC."""
    cfg, params, pcfg, model = _pair(d, 61 + d)
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
                                    length_aware=masked, compute_dtype=torch.float32)(
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


# --- the split's arithmetic -----------------------------------------------------


def _tf32_hi(x):
    """x with its 13 low mantissa bits cleared: the TF32 value the card's
    wgmma reads from an f32 operand (`w2v2_tf32_probe` checks it on the
    card)."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_rna(x):
    """x rounded to TF32, to nearest with ties away from zero, on the bits."""
    return ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """(hi, lo) as the card reads them: the raw bits as hi (read truncated)
    and lo = x - hi (exact in f32) rounded to TF32 (`lo_of_raw`)."""
    hi = _tf32_hi(x)
    return hi, _tf32_rna(x - hi)


def _rz(x):
    """f64 x rounded toward zero to f32: the card's tensor-core accumulation
    as modelled here (a k step's 8 products summed exactly, added to the
    accumulator, the sum truncated)."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x), np.nextafter(f, np.float32(0)), f)


def _three_tf32(a, b, partial=64, lo=_tf32_rna):
    """a (M, K) @ b (N, K)^T as `csrc/flash_attention_f32_wide.cu` forms it:
    hi the raw bits, lo = x - hi rounded to TF32 (`lo(x - hi)` as the card
    reads it); per `partial` columns of K an accumulator of its own, to
    which each k step of 8 adds a_lo b_hi, a_hi b_lo, a_hi b_hi in that
    order, each add truncated (`_rz`).  A slab of 8 k steps (`rows_entry`)
    issues its second half's two shared-memory products first and their lo
    x hi products after them.  The partials are added in f32, rounded to
    nearest."""
    ahi, bhi = _tf32_hi(a), _tf32_hi(b)
    alo, blo = _tf32_hi(lo(a - ahi)), _tf32_hi(lo(b - bhi))
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], partial):
        steps = list(range(k0, min(k0 + partial, a.shape[1]), 8))
        first, second = (steps[:4], steps[4:]) if len(steps) == 8 else (steps, [])
        order = [(x, y, k) for k in first for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi))]
        order += [(x, y, k) for k in second for x, y in ((ahi, blo), (ahi, bhi))]
        order += [(alo, bhi, k) for k in second]
        part = np.zeros_like(acc)
        for x, y, k in order:
            part = _rz(part.astype(np.float64) + x[:, k:k + 8].astype(np.float64) @ y[:, k:k + 8].astype(np.float64).T)
        acc = acc + part
    return acc


def _products(kind, d, rng):
    """The operands of one of the kernels' two kinds of product at head dim
    d: "scores" (S = Q K^T: 64 queries x 32 keys, K = d, `rows_entry`) or
    "output" (O += P V: P 64 x 32 probabilities in [0, 1], V^T d x 32, K =
    the 32 keys, `cols_entry`)."""
    if kind == "scores":
        return (rng.standard_normal((64, d)).astype(np.float32) / np.float32(d ** 0.5),
                rng.standard_normal((32, d)).astype(np.float32))
    p = rng.random((64, 32)).astype(np.float32)
    return p / p.sum(-1, keepdims=True), rng.standard_normal((d, 32)).astype(np.float32)


def _errors(kind, d, **design):
    """(|error| against the f64 product, 2^-20 x sum_k |a_k b_k|, a, b, the
    f64 product) of `_three_tf32(**design)` on seeded inputs."""
    a, b = _products(kind, d, np.random.default_rng(90 + d))
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    bound = 2.0 ** -20 * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64).T)
    got = _three_tf32(a, b, **design)
    assert got.dtype == np.float32
    return np.abs(got - exact), bound, a, b, exact


@pytest.mark.parametrize("kind", ["scores", "output"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_three_tf32_products_within_2_to_the_minus_20_of_the_f64_product(d, kind):
    """The kernels' three TF32 products against the f64 product on seeded
    inputs, the card's accumulation modelled as truncating: every element
    within 2^-20 x sum_k |a_k b_k|, and on average within a tenth of it.
    One TF32 product (hi x hi) misses the first bound on most elements, so
    the bound can fail."""
    err, bound, a, b, exact = _errors(kind, d)
    assert (err <= bound).all(), (err / bound).max()
    assert err.mean() <= bound.mean() / 10, err.mean() / bound.mean()
    one = _tf32_hi(a).astype(np.float64) @ _tf32_hi(b).astype(np.float64).T
    assert (np.abs(one - exact) > bound).mean() > 0.9


@pytest.mark.parametrize("design", ["one accumulator over D", "lo truncated"])
def test_three_tf32_products_miss_the_bound_in_the_designs_the_card_refused(design):
    """The two designs that failed the card's f32 tests at their bounds miss
    the emulation's average bound at D = 256: the scores as one truncating
    chain of 96 products over all of D (no 64-column partials), and the
    output with each lo left to the card's truncation (not rounded to
    TF32).  So the emulation pins the partials and the rounded lo."""
    if design == "one accumulator over D":
        err, bound, *_ = _errors("scores", 256, partial=256)
    else:
        err, bound, *_ = _errors("output", 256, lo=lambda x: x)
    assert err.mean() > bound.mean() / 10, err.mean() / bound.mean()


@pytest.mark.parametrize("scale", [1.0, 2.0 ** -30, 2.0 ** 30])
def test_tf32_split_parts_are_tf32_and_within_2_to_the_minus_21(scale):
    """Both parts of the split are TF32 values (the card reads them whole),
    x - hi is exact in f32, and |x - hi - lo| <= 2^-21 |x|, at any scale."""
    x = (np.random.default_rng(3).standard_normal(100000) * scale).astype(np.float32)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    rest = x.astype(np.float64) - hi.astype(np.float64)
    assert np.array_equal(rest, (x - hi).astype(np.float64))
    err = np.abs(rest - lo.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x)).all()


# --- the TMA layout of f32 views at 4, 6 and 8 boxes a row ------------------------


@pytest.mark.parametrize("b,h,l", [(8, 8, 768), (16, 4, 768), (1, 4, 5999), (3, 2, 1)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_wide_contiguous_heads_map_rows_then_heads(d, b, h, l):
    """Rows of D f32 are 4 D bytes: dims (D, L, H, B), the box 32 rows x 32
    columns (one 128-byte swizzle row; D / 32 boxes a row: 4, 6, 8)."""
    x = torch.zeros(b, h, l, d)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride(), x.element_size())
    assert not heads_inner
    assert dims == [d, l, h, b]
    if l > 1:
        assert strides == [4 * d, l * 4 * d, h * l * 4 * d]
    assert box == [32, 32, 1, 1] and d // box[0] == {128: 4, 192: 6, 256: 8}[d]
    assert _strided_ok(x) and _layout_ok(tuple(x.shape), x.stride(), 4)


@pytest.mark.parametrize("b,h,l", [(8, 8, 768), (16, 4, 768), (2, 3, 65)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_wide_projection_views_map_heads_then_rows(d, b, h, l):
    """The (B, L, H x D) f32 projections' head views are read in place,
    32 rows a box; bf16 keeps its 64-row boxes at the same head dims."""
    x = torch.zeros(b, l, h * d).view(b, l, h, d).transpose(1, 2)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride(), 4)
    assert heads_inner
    assert dims == [d, h, l, b]
    assert strides == [4 * d, h * 4 * d, l * h * 4 * d]
    assert box == [32, 1, 32, 1]
    assert _strided_ok(x)
    assert tma_layout(x.shape, x.stride(), 2)[2] == [64, 1, 64, 1]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_wide_views_that_break_tma_rules_are_refused_and_copied(d):
    """A base 4 bytes past a 16-byte boundary and rows D + 2 f32 apart (not
    a 16-byte multiple) are refused, and `_dense` copies them into a layout
    TMA reads; rows D + 4 apart are read in place."""
    base = torch.arange(2 * 3 * 40 * d, dtype=torch.float32)
    x = torch.empty(base.numel() + 4)[1:1 + base.numel()].view(2, 3, 40, d)
    x.copy_(base.view(2, 3, 40, d))
    for bad in (x, torch.zeros(2, 3, 40, d + 2)[..., :d]):
        assert not _strided_ok(bad)
        y = _dense(bad)
        assert _strided_ok(y) and y.is_contiguous() and torch.equal(y, bad)
    assert _strided_ok(torch.zeros(2, 3, 40, d + 4)[..., :d])


# --- the card's dispatch ---------------------------------------------------------


def test_flash_supports_f32_at_every_kernel_head_dim():
    """f32 takes the kernels at head dims 64, 128, 192 and 256, where JAX
    runs its Pallas kernels on f32 inputs; 80, 120 and 320 run the plain
    attention in either dtype; bf16 is as it was."""
    for d in (64, 128, 192, 256):
        assert flash_attention.supports(d, torch.float32), d
        assert flash_attention.supports(d, torch.bfloat16), d
    for d in (80, 120, 320):
        assert not flash_attention.supports(d, torch.float32), d
        assert not flash_attention.supports(d, torch.bfloat16), d
    for dtype in (torch.float16, torch.float64):
        assert not flash_attention.supports(128, dtype), dtype


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_check_takes_f32_at_wide_heads_and_refuses_320(d):
    """`_check` keeps f32 projection views at 128-256 as they are and
    raises at 320, which no instance takes."""
    q, k, v = (torch.zeros(2, 50, 4 * d).view(2, 50, 4, d).transpose(1, 2) for _ in range(3))
    qq, kk, vv, bias = _check("t", q, k, v, torch.zeros(2, 50))
    assert qq is q and kk is k and vv is v and bias.dtype == torch.float32
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(2, 4, 50, 320)
        _check("t", x, x, x, None)
