"""The flash kernels' head dim 128 against the JAX package on the CPU.

The port's plain forward and backward (what the wrappers run for a CPU
tensor) against JAX's `flash_attention` and its custom-VJP gradients with
the Pallas kernels in interpret mode, at (2, 2, L, 128); a tiny robust model
with 2 heads of 128 against the JAX forward and stage-2 loss with
`attention_impl="flash"` (Pallas in interpret mode); the TMA layout the
wrappers hand the kernels at D = 128; and the card's dispatch by head dim.
Inputs come from numpy seeds.
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
D = 128
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


# --- the forward and backward at D = 128 --------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
def test_flash_plain_matches_pallas_at_head_dim_128(l, rate):
    """The plain forward against the Pallas kernel in interpret mode, ragged
    bias, dropout 0.3 under one seed (L = 200 hashes with the padded stride
    256), atol 1e-4 as at head dim 64."""
    q, k, v = _qkv(5, l)
    bias = _ragged_bias(l)
    want = np.asarray(jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(bias),
                                             dropout_rate=rate, dropout_seed=21, interpret=True))
    out, lse = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(bias.reshape(2, l)), dropout_rate=rate, seed=21)
    assert out.shape == (2, 2, l, D) and lse.shape == (2, 2, l) and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [200, 256])
def test_flash_grads_match_pallas_at_head_dim_128(l, rate):
    """`FlashAttention`'s plain backward against jax.grad through the Pallas
    kernels in interpret mode (the custom VJP), ragged bias, same dropout
    seed; atol 1e-3 of tests/test_flash_attention.py."""
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
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-3, err_msg=f"d{name}")


# --- a tiny robust model with 2 heads of 128 ----------------------------------


def _pair(seed):
    """The tiny robust config at hidden 256 with 2 heads of 128 (2 layers),
    JAX params loaded into the port's model."""
    cfg = tiny_config(robust=True, hidden_size=256, num_heads=2, intermediate_size=512)
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


def test_tiny_model_at_head_dim_128_matches_jax_flash(pallas_interpret):
    """Hidden states (atol 1e-3) and logits with a ragged mask (atol 4e-3)
    of the port on the CPU against the JAX forward through the Pallas
    flash kernels."""
    cfg, params, pcfg, model = _pair(3)
    speech, mask = _speech_and_mask()
    jx = dict(attention_impl="flash")
    want_h = np.asarray(jax_modeling.wav2vec2_forward(params["wav2vec2"], cfg, jnp.asarray(speech),
                                                      **jx))
    want = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech), jnp.asarray(mask), **jx))
    with torch.no_grad():
        got_h = modeling.wav2vec2_forward(model.wav2vec2, pcfg, torch.from_numpy(speech)).numpy()
        got = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(speech), torch.from_numpy(mask)).numpy()
    assert got_h.shape == want_h.shape and got.shape == want.shape
    np.testing.assert_allclose(got_h, want_h, atol=1e-3)
    np.testing.assert_allclose(got, want, atol=4e-3)


STAGE2 = ("feature_extractor",)


def test_tiny_model_at_head_dim_128_stage2_grads_match_jax_flash(pallas_interpret):
    """The stage-2 loss (rtol 1e-5) and gradients (atol 1e-4) with the mask
    and length-aware CTC against `jax.value_and_grad` through the Pallas
    flash kernels' custom VJP, as tests/test_torch_robust.py does at head
    dim 64 through XLA."""
    cfg, params, pcfg, model = _pair(4)
    rng = np.random.default_rng(0)
    labels = np.zeros((2, 10), np.int32)
    for i in range(2):
        n = rng.integers(3, 8)
        labels[i, :n] = rng.integers(1, 32, size=n)
    mask = np.ones((2, SEQLEN), np.int32)
    mask[1, 6000:] = 0
    batch = {"speech": rng.standard_normal((2, SEQLEN)).astype(np.float32), "labels": labels,
             "attention_mask": mask}
    loss_fn = jax_trainer._make_ctc_loss_fn(
        cfg, division_factor=2.0, with_attention_mask=True, length_aware=True,
        compute_dtype=jnp.float32, remat=False, mesh=None, attention_impl="flash", frozen=STAGE2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.value_and_grad(loss_fn)(params, jb, jax.random.PRNGKey(0))
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    trainable = state.set_trainable(model, STAGE2)
    loss = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0, with_attention_mask=True,
                                    length_aware=True)(model, batch, torch.Generator().manual_seed(0))
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


# --- the TMA layout at D = 128 ----------------------------------------------------


def _proj_view(b, l, h):
    """The head split of a (B, L, H*128) projection, as `split_heads` gives it."""
    return torch.zeros(b, l, h * D, dtype=torch.bfloat16).view(b, l, h, D).transpose(1, 2)


@pytest.mark.parametrize("b,h,l", [(8, 8, 768), (1, 8, 5999), (3, 2, 1)])
def test_contiguous_heads_at_head_dim_128_map_rows_then_heads(b, h, l):
    """Rows of 256 bytes: dims (128, L, H, B), the box 64 rows x 64 columns
    (one 128-byte swizzle row; two boxes a row of 128)."""
    x = torch.zeros(b, h, l, D, dtype=torch.bfloat16)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride())
    assert not heads_inner
    assert dims == [D, l, h, b]
    if l > 1:
        assert strides == [256, l * 256, h * l * 256]
    assert box == [64, 64, 1, 1]
    assert _strided_ok(x) and _layout_ok(tuple(x.shape), x.stride())


@pytest.mark.parametrize("b,h,l", [(8, 8, 768), (1, 8, 5999), (2, 3, 65)])
def test_projection_views_at_head_dim_128_map_heads_then_rows(b, h, l):
    """The (B, L, 8 x 128) projections' head views are read in place."""
    x = _proj_view(b, l, h)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride())
    assert heads_inner
    assert dims == [D, h, l, b]
    assert strides == [256, h * 256, l * h * 256]
    assert box == [64, 1, 64, 1]
    assert _strided_ok(x)


def test_head_dim_128_views_that_break_tma_rules_are_refused():
    """Rows 132 elements apart (264 bytes, not a 16-byte multiple) and
    overlapping heads are refused, rows 136 apart (272 bytes) are read in
    place; head dims without an instance (80, 120, 320) are refused, those
    with one (192, 256) taken."""
    assert not _strided_ok(torch.zeros(2, 3, 40, 132, dtype=torch.bfloat16)[..., :128])
    assert _strided_ok(torch.zeros(2, 3, 40, 136, dtype=torch.bfloat16)[..., :128])
    assert not _strided_ok(torch.zeros(2, 1, 40, D, dtype=torch.bfloat16).expand(2, 3, 40, D))
    for d in (80, 120, 320):
        assert not _layout_ok((2, 3, 40, d), torch.zeros(2, 3, 40, d).stride())
    for d in (192, 256):
        assert _layout_ok((2, 3, 40, d), torch.zeros(2, 3, 40, d).stride())


# --- the card's dispatch ----------------------------------------------------------


def test_flash_supports_head_dims_64_and_128_in_bf16():
    """The kernels take heads of 64 and 128 (and 192 and 256) in bf16: a
    model with heads of 128 runs them on the card, as JAX runs Pallas
    there; 80, 120 and 320 (no instance) run the plain attention, and so
    does f32 at every head dim but 64 (the one f32 instance)."""
    assert flash_attention.supports(128, torch.bfloat16)
    assert flash_attention.supports(64, torch.bfloat16)
    for d in (192, 256):
        assert flash_attention.supports(d, torch.bfloat16), d
    for d in (80, 120, 320):
        assert not flash_attention.supports(d, torch.bfloat16), d
    assert flash_attention.supports(64, torch.float32)
    for d in (128, 192, 256):
        assert not flash_attention.supports(d, torch.float32), d
