"""The pos conv at 32, 96, 112 and 128 channels a group, against the JAX package on the CPU.

JAX sends every bf16 pos conv whose tap count is a multiple of 16 to its
Pallas kernels, at any C/G; the port's CUDA kernels take the multiples of
16 up to 128 and 120.  Here, at the four widths that joined them (512,
1536, 1792 and 2048 channels in 16 groups; base and robust/large widths in
8 groups are 96 and 128): the plain versions the wrappers run for a CPU
tensor against `pos_conv_fused` and `pos_conv_fused_train`'s VJP in
interpret mode, and tiny models of each geometry against the JAX model
(hidden states, logits, stage-2 loss and gradients).  Inputs come from
numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import port_config_of
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.ops.pallas import pos_conv as jax_pos_conv_pallas
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused as jax_pos_conv
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused_train as jax_pos_conv_train
from gsoc_wav2vec2_tpu.training import trainer as jax_trainer
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv
from gsoc_wav2vec2_tpu_torch.training import state, trainer

torch.set_num_threads(2)
WIDTHS = (32, 96, 112, 128)
SEQLEN = 8000
STAGE2 = ("feature_extractor",)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly, so that both packages start from
    the same bf16 operands."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _case(t, cg, seed, g=2, k=32):
    c = g * cg
    rng = np.random.default_rng(seed + t + cg)
    x = _bf16_exact(rng.standard_normal((2, t, c)))
    kernel = (rng.standard_normal((k, cg, c)) * (1.5 / np.sqrt(k * cg))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = _bf16_exact(rng.standard_normal((2, t, c)))
    return x, kernel, bias, dy, g, k


def _close_bf16(got: torch.Tensor, want: np.ndarray) -> None:
    """bf16 outputs of the same bf16 operands, f32 sums in another order:
    within one bf16 ulp of the scale (2^-8 relative), on average 1e-3 of it."""
    scale = np.abs(want).max()
    diff = np.abs(got.float().numpy() - want)
    assert got.shape == want.shape
    assert diff.max() <= 2.0 ** -8 * scale and diff.mean() <= 1e-3 * scale


@pytest.mark.parametrize("t", [40, 37])
@pytest.mark.parametrize("cg", WIDTHS)
def test_pos_conv_plain_matches_pallas(cg, t):
    """`pos_conv_plain` and `pos_conv_train_fwd_plain` against
    `pos_conv_fused` and `pos_conv_fused_train` in interpret mode (g = 2, K
    = 32, an even and an odd T); the kept f32 pre-activation is GELU's
    input.  The card dispatch takes the kernels at this width."""
    x, kernel, bias, _, g, k = _case(t, cg, seed=0)
    assert pos_conv.supports(16 * cg, 16, torch.bfloat16, 128) and pos_conv.supports(g * cg, g, torch.bfloat16, k)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_pos_conv(xb, jnp.asarray(kernel), jnp.asarray(bias), kernel_size=k,
                                   groups=g, gelu_approx=True, interpret=True), np.float32)
    want_train = np.asarray(jax_pos_conv_train(xb, jnp.asarray(kernel), jnp.asarray(bias),
                                               kernel_size=k, groups=g, gelu_approx=True,
                                               interpret=True), np.float32)
    xt = _t(x).to(torch.bfloat16)
    got = pos_conv.pos_conv_plain(xt, _t(kernel), _t(bias), groups=g, gelu_approx=True)
    got_train, pre = pos_conv.pos_conv_train_fwd_plain(xt, _t(kernel), _t(bias), groups=g,
                                                       gelu_approx=True)
    assert got.dtype == got_train.dtype == torch.bfloat16 and pre.dtype == torch.float32
    _close_bf16(got, want)
    _close_bf16(got_train, want_train)
    torch.testing.assert_close(torch.nn.functional.gelu(pre, approximate="tanh").to(torch.bfloat16),
                               got_train, rtol=0, atol=0)


@pytest.mark.parametrize("t", [40, 37])
@pytest.mark.parametrize("cg", WIDTHS)
def test_pos_conv_vjp_matches_pallas(cg, t):
    """dx, dW and db of `pos_conv_fused_train`'s `jax.vjp` (`_dx_call` and
    `_dw_call` in interpret mode) against the port's backward pieces.  The
    port's f32 dpre (GELU' of its own pre-activation) is held against JAX's
    at 1e-5 of its scale; dx and dW are fed JAX's dpre rounded to bf16, as
    at 120 channels a group (`tests/test_torch_xlarge.py`): dx within one
    bf16 ulp of its scale (mean 1e-3), dW and db within 1e-5 of theirs.  The
    autograd function the model calls gives the port's own pieces."""
    x, kernel, bias, dy, g, k = _case(t, cg, seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    dyb = jnp.asarray(dy).astype(jnp.bfloat16)

    def fwd(xv, kv, bv):
        return jax_pos_conv_train(xv, kv, bv, kernel_size=k, groups=g, gelu_approx=True,
                                  interpret=True)

    _, vjp = jax.vjp(fwd, xb, jnp.asarray(kernel), jnp.asarray(bias))
    want_dx, want_dw, want_db = (np.asarray(a, np.float32) for a in vjp(dyb))

    _, want_pre = jax_pos_conv_pallas._fwd_train_call(
        xb, jnp.asarray(kernel), jnp.asarray(bias), k=k, g=g, gelu_approx=True, interpret=True)
    _, gelu_vjp = jax.vjp(lambda p: jax.nn.gelu(p, approximate=True), want_pre)
    (want_dpre,) = gelu_vjp(jax_pos_conv_pallas._group(dyb, g).astype(jnp.float32))
    want_dpre = np.asarray(jax_pos_conv_pallas._ungroup(want_dpre))

    xt = _t(x).to(torch.bfloat16)
    _, pre = pos_conv.pos_conv_train_fwd_plain(xt, _t(kernel), _t(bias), groups=g, gelu_approx=True)
    dpre = torch.ops.aten.gelu_backward(_t(dy), pre, approximate="tanh")
    assert np.abs(dpre.numpy() - want_dpre).max() <= 1e-5 * np.abs(want_dpre).max()
    db = dpre.sum(dim=(0, 1)).numpy()
    jdpre = _t(want_dpre).to(torch.bfloat16)
    dx = pos_conv.pos_conv_dx_plain(jdpre, _t(kernel), groups=g)
    dw = pos_conv.pos_conv_dw_plain(xt, jdpre, k, groups=g)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32 and dw.shape == (k, cg, g * cg)
    _close_bf16(dx, want_dx)
    for got, want in ((dw.numpy(), want_dw), (db, want_db)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    own = dpre.to(torch.bfloat16)
    tx, tk, tb = (_t(a, requires_grad=True) for a in (x, kernel, bias))
    xin = tx.to(torch.bfloat16)
    xin.retain_grad()
    pos_conv.PosConvTrain.apply(xin, tk, tb, g, True).backward(_t(dy).to(torch.bfloat16))
    assert torch.equal(xin.grad, pos_conv.pos_conv_dx_plain(own, _t(kernel), groups=g))
    assert torch.equal(tk.grad, pos_conv.pos_conv_dw_plain(xt, own, k, groups=g))


# tiny models of each geometry: hidden 2 C/G in 2 pos-conv groups, 2 heads of
# C/G, 2 layers, narrow convs; 32 and 96 in the base family (base_g8's), 112
# and 128 in the robust/large one (robust_g8's)
def _pair(cg, seed, with_head=True):
    robust = cg > 96
    cfg = tiny_config(robust=robust, hidden_size=2 * cg, num_heads=2,
                      num_conv_pos_embedding_groups=2, intermediate_size=8 * cg, num_layers=2,
                      conv_bias=robust)
    init = (jax_modeling.init_wav2vec2_for_ctc_params if with_head
            else jax_modeling.init_wav2vec2_params)
    params = init(jax.random.PRNGKey(seed), cfg)
    pcfg = port_config_of(cfg)
    assert pcfg.hidden_size // pcfg.num_conv_pos_embedding_groups == cg
    cls = modeling.Wav2Vec2ForCTC if with_head else modeling.Wav2Vec2Model
    model = cls(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, params, pcfg, model


@pytest.mark.parametrize("cg", WIDTHS)
def test_tiny_model_hidden_states_match_jax(cg):
    """The encoder's output at this geometry against the f32 JAX forward,
    atol 1e-3 (tests/test_torch_model.py's bound)."""
    cfg, params, pcfg, model = _pair(cg, seed=cg, with_head=False)
    speech = np.random.default_rng(cg).standard_normal((2, SEQLEN)).astype(np.float32)
    want = np.asarray(jax_modeling.wav2vec2_forward(params, cfg, jnp.asarray(speech)))
    with torch.no_grad():
        got = modeling.wav2vec2_forward(model, pcfg, torch.from_numpy(speech)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("cg", WIDTHS)
def test_tiny_model_logits_match_jax_with_ragged_mask(cg):
    """Logits of a ragged batch with its mask against the f32 JAX forward:
    the port's f32 forward atol 4e-3 (tests/test_parity.py's logits bound),
    its bf16 forward within 10% of the logit scale."""
    cfg, params, pcfg, model = _pair(cg, seed=cg + 1)
    b = 3
    speech = np.random.default_rng(cg + 2).standard_normal((b, SEQLEN)).astype(np.float32)
    mask = np.zeros((b, SEQLEN), np.int64)
    for i, n in enumerate([SEQLEN, SEQLEN - 1700, SEQLEN - 3333]):
        mask[i, :n] = 1
        speech[i, n:] = 0.0
    want = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech), jnp.asarray(mask)))
    with torch.no_grad():
        f32 = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(speech), torch.from_numpy(mask)).numpy()
        bf16 = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(speech), torch.from_numpy(mask),
            compute_dtype=torch.bfloat16).numpy()
    assert f32.shape == bf16.shape == want.shape
    np.testing.assert_allclose(f32, want, atol=4e-3)
    assert np.abs(bf16 - want).max() < 0.1 * np.abs(want).max()


@pytest.mark.parametrize("cg", WIDTHS)
def test_tiny_model_stage2_loss_and_grads_match_jax(cg):
    """The stage-2 loss and gradients (conv stack frozen, f32) against
    `jax.value_and_grad`: loss rtol 1e-5, gradients atol 1e-4 (as
    tests/test_torch_xlarge.py's `_stage2_matches_jax`); the robust family
    with its mask and length-aware CTC.  The pos conv's weights get a
    gradient."""
    stage2_matches_jax(cg, grad_rtol=0.0)


def stage2_matches_jax(cg, grad_rtol):
    """The tiny model's stage-2 loss (rtol 1e-5) and gradients against JAX,
    each gradient within max(1e-4, `grad_rtol` x its largest magnitude)."""
    cfg, params, pcfg, model = _pair(cg, seed=cg + 3)
    masked = cfg.is_robust
    rng = np.random.default_rng(cg + 4)
    labels = np.zeros((2, 10), np.int32)
    for i in range(2):
        n = rng.integers(3, 8)
        labels[i, :n] = rng.integers(1, 32, size=n)
    mask = np.ones((2, SEQLEN), np.int32)
    mask[1, 6000:] = 0
    batch = {"speech": rng.standard_normal((2, SEQLEN)).astype(np.float32), "labels": labels,
             "attention_mask": mask}
    loss_fn = jax_trainer._make_ctc_loss_fn(
        cfg, division_factor=2.0, with_attention_mask=masked, length_aware=masked,
        compute_dtype=jnp.float32, remat=False, mesh=None, attention_impl="auto", frozen=STAGE2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.value_and_grad(loss_fn)(params, jb, jax.random.PRNGKey(0))
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    trainable = state.set_trainable(model, STAGE2)
    loss = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0, with_attention_mask=masked,
                                    length_aware=masked)(
        model, batch, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert model.wav2vec2.encoder.pos_conv_embed.conv.weight_v.grad is not None
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        if trainable[name]:
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
            assert p.grad is not None or name == "wav2vec2.masked_spec_embed", name
            np.testing.assert_allclose(got, want, atol=max(1e-4, grad_rtol * np.abs(want).max()),
                                       err_msg=name)
        else:
            assert p.grad is None and not want.any(), name
