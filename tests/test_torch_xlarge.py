"""The 1280-d family (HuBERT-xlarge, XLS-R 1B, MMS-1B) and XLS-R 2B's 1920-d
of the port against the JAX package on the CPU.

These checkpoints are 1280 (1920) channels wide with 16 positional-conv
groups and 16 heads: 80 (120) channels a group, the width of the pos-conv
kernels' C/G = 80 (120) instances, and a head dim of 80 (120), where
neither package has a flash kernel.  Here: the pos conv's plain versions
against JAX's Pallas kernels in interpret mode at C/G = 80 and 120 (value
and VJP), tiny models of both shapes against the JAX model (logits, stage-2
loss and gradients), and both packages' reading of the published configs.
Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import port_config_of
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.models import config as jax_config
from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.ops.pallas import pos_conv as jax_pos_conv_pallas
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused as jax_pos_conv
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused_train as jax_pos_conv_train
from gsoc_wav2vec2_tpu.training import trainer as jax_trainer
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention, pos_conv
from gsoc_wav2vec2_tpu_torch.training import state, trainer

torch.set_num_threads(2)
SEQLEN = 8000
CG = 80  # channels a pos-conv group in the 1280-d family (1280 / 16)
CG_2B = 120  # in XLS-R 2B (1920 / 16)
# (C/G, T) of the pos-conv tests; the 80-channel cases keep their first ids
POS_CONV_CASES = [pytest.param(CG, 40, id="40"), pytest.param(CG, 37, id="37"),
                  pytest.param(CG_2B, 40, id="cg120-40"), pytest.param(CG_2B, 37, id="cg120-37")]


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly, so that both packages start from
    the same bf16 operands."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _pos_conv_case(t, cg, g=2, k=32, seed=0):
    c = g * cg
    rng = np.random.default_rng(seed + t)
    x = _bf16_exact(rng.standard_normal((2, t, c)))
    kernel = (rng.standard_normal((k, cg, c)) * (1.5 / np.sqrt(k * cg))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = _bf16_exact(rng.standard_normal((2, t, c)))
    return x, kernel, bias, dy, g, k


@pytest.mark.parametrize("cg,t", POS_CONV_CASES)
def test_pos_conv_plain_at_80_channels_a_group_matches_pallas(cg, t):
    """`pos_conv_plain` and `pos_conv_train_fwd_plain`'s output against
    `pos_conv_fused` and `pos_conv_fused_train` in interpret mode at C/G = 80,
    and at XLS-R 2B's 120 (g = 2, K = 32, an even and an odd T): the same
    bf16 operands and f32 sums in another order, so the bf16 outputs agree
    to one bf16 ulp of their scale (2^-8 relative) and on average to 1e-3 of
    it."""
    x, kernel, bias, _, g, k = _pos_conv_case(t, cg)
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
    scale = np.abs(want).max()
    for a, b in ((got, want), (got_train, want_train)):
        diff = np.abs(a.float().numpy() - b)
        assert a.shape == b.shape == (2, t, g * cg)
        assert diff.max() <= 2.0 ** -8 * scale and diff.mean() <= 1e-3 * scale
    # the kept pre-activation is GELU's input
    torch.testing.assert_close(torch.nn.functional.gelu(pre, approximate="tanh").to(torch.bfloat16),
                               got_train, rtol=0, atol=0)


@pytest.mark.parametrize("cg,t", POS_CONV_CASES)
def test_pos_conv_vjp_at_80_channels_a_group_matches_pallas(cg, t):
    """dx and dW of `pos_conv_fused_train`'s `jax.vjp` (Pallas `_dx_call` and
    `_dw_call` in interpret mode) against the port's backward pieces: GELU'
    from `pos_conv_train_fwd_plain`'s pre-activation, dpre rounded to bf16 as
    both packages do, then `pos_conv_dx_plain` and `pos_conv_dw_plain`.  dx
    is bf16 (one bf16 ulp of its scale, mean 1e-3 of it); dW and db are f32
    sums of the same bf16 products in another order (1e-5 of their scale).
    The autograd function the model calls gives those pieces.

    At C/G = 80 the chain runs end to end from the port's own dpre.  At 120
    the port's f32 dpre is held against JAX's (`_train_bwd`'s, from the
    pre-activation it keeps) at 1e-5 of its scale; the two differ in the
    last bits, and rounded to bf16 a few dozen of them fall on either side of
    a bf16 step, which moves dW past 1e-5 of its scale at these inputs.  So
    there dx and dW take JAX's dpre rounded to bf16, and are held at the
    same tolerances."""
    x, kernel, bias, dy, g, k = _pos_conv_case(t, cg, seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    dyb = jnp.asarray(dy).astype(jnp.bfloat16)

    def fwd(xv, kv, bv):
        return jax_pos_conv_train(xv, kv, bv, kernel_size=k, groups=g, gelu_approx=True,
                                  interpret=True)

    _, vjp = jax.vjp(fwd, xb, jnp.asarray(kernel), jnp.asarray(bias))
    want_dx, want_dw, want_db = (np.asarray(a, np.float32) for a in vjp(dyb))

    xt = _t(x).to(torch.bfloat16)
    _, pre = pos_conv.pos_conv_train_fwd_plain(xt, _t(kernel), _t(bias), groups=g, gelu_approx=True)
    dpre = torch.ops.aten.gelu_backward(_t(dy), pre, approximate="tanh")
    db = dpre.sum(dim=(0, 1)).numpy()
    own = dpre.to(torch.bfloat16)
    own_dx = pos_conv.pos_conv_dx_plain(own, _t(kernel), groups=g)
    own_dw = pos_conv.pos_conv_dw_plain(xt, own, k, groups=g)
    if cg == CG:
        dx, dw = own_dx, own_dw
    else:
        # JAX's dpre as `_train_bwd` forms it, from the pre-activation it keeps
        _, want_pre = jax_pos_conv_pallas._fwd_train_call(
            xb, jnp.asarray(kernel), jnp.asarray(bias), k=k, g=g, gelu_approx=True,
            interpret=True)
        _, gelu_vjp = jax.vjp(lambda p: jax.nn.gelu(p, approximate=True), want_pre)
        (want_dpre,) = gelu_vjp(jax_pos_conv_pallas._group(dyb, g).astype(jnp.float32))
        want_dpre = np.asarray(jax_pos_conv_pallas._ungroup(want_dpre))
        assert np.abs(dpre.numpy() - want_dpre).max() <= 1e-5 * np.abs(want_dpre).max()
        jdpre = _t(want_dpre).to(torch.bfloat16)
        dx = pos_conv.pos_conv_dx_plain(jdpre, _t(kernel), groups=g)
        dw = pos_conv.pos_conv_dw_plain(xt, jdpre, k, groups=g)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32 and dw.shape == (k, cg, g * cg)
    scale = np.abs(want_dx).max()
    diff = np.abs(dx.float().numpy() - want_dx)
    assert diff.max() <= 2.0 ** -8 * scale and diff.mean() <= 1e-3 * scale
    for got, want in ((dw.numpy(), want_dw), (db, want_db)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the autograd function the model calls gives the same pieces on the CPU
    tx, tk, tb = (_t(a, requires_grad=True) for a in (x, kernel, bias))
    xin = tx.to(torch.bfloat16)
    xin.retain_grad()
    pos_conv.PosConvTrain.apply(xin, tk, tb, g, True).backward(_t(dy).to(torch.bfloat16))
    assert torch.equal(xin.grad, own_dx) and torch.equal(tk.grad, own_dw)


# tiny models of the 1280-d and 1920-d shapes: pos conv at 80 (120) channels
# a group (2 groups of 160 or 240), head dim 80 (120; 2 heads),
# stable-layer-norm layers, narrow convs
def _wide_tiny(cg):
    return dict(hidden_size=2 * cg, num_heads=2, num_conv_pos_embedding_groups=2,
                intermediate_size=4 * 2 * cg, num_layers=2, conv_bias=True)


XLARGE_TINY = _wide_tiny(CG)
XLS_R_2B_TINY = _wide_tiny(CG_2B)


def _xlarge_pair(seed, shape=XLARGE_TINY):
    cfg = tiny_config(robust=True, **shape)
    params = jax_modeling.init_wav2vec2_for_ctc_params(jax.random.PRNGKey(seed), cfg)
    pcfg = port_config_of(cfg)
    model = modeling.Wav2Vec2ForCTC(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, params, pcfg, model


def _speech_and_mask(b=3, seed=2):
    speech = np.random.default_rng(seed).standard_normal((b, SEQLEN)).astype(np.float32)
    mask = np.zeros((b, SEQLEN), np.int64)
    for i, n in enumerate([SEQLEN, SEQLEN - 1700, SEQLEN - 3333][:b]):
        mask[i, :n] = 1
        speech[i, n:] = 0.0
    return speech, mask


def _logits_match_jax(shape, cg, seed):
    """The tiny wide model's logits against the f32 JAX forward with a
    ragged mask, at tests/test_torch_robust.py's tolerances: the port's f32
    forward atol 4e-3 (tests/test_parity.py's logits bound), its bf16 forward
    within 10% of the logit scale.  The head dim and C/G are both `cg`."""
    cfg, params, pcfg, model = _xlarge_pair(seed=seed, shape=shape)
    assert pcfg.hidden_size // pcfg.num_heads == cg
    assert pcfg.hidden_size // pcfg.num_conv_pos_embedding_groups == cg
    speech, mask = _speech_and_mask()
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


def test_xlarge_shaped_logits_match_jax():
    """`_logits_match_jax` at the 1280-d shape: head dim 80, C/G 80."""
    _logits_match_jax(XLARGE_TINY, CG, seed=17)


def test_xls_r_2b_shaped_logits_match_jax():
    """`_logits_match_jax` at XLS-R 2B's 1920-d shape: head dim 120, C/G
    120 (hidden 240)."""
    _logits_match_jax(XLS_R_2B_TINY, CG_2B, seed=23)


STAGE2 = ("feature_extractor",)


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    labels = np.zeros((b, 10), np.int32)
    for i in range(b):
        n = rng.integers(3, 8)
        labels[i, :n] = rng.integers(1, 32, size=n)
    mask = np.ones((b, SEQLEN), np.int32)
    mask[1, 6000:] = 0
    return {"speech": rng.standard_normal((b, SEQLEN)).astype(np.float32), "labels": labels,
            "attention_mask": mask}


def _stage2_matches_jax(shape, seed, masked):
    """The tiny wide model's stage-2 loss and gradients (conv stack frozen,
    f32) against `jax.value_and_grad`, at tests/test_torch_robust.py's
    tolerances: loss rtol 1e-5, gradients atol 1e-4."""
    cfg, params, pcfg, model = _xlarge_pair(seed=seed, shape=shape)
    batch = _batch()
    loss_fn = jax_trainer._make_ctc_loss_fn(
        cfg, division_factor=2.0, with_attention_mask=masked, length_aware=masked,
        compute_dtype=jnp.float32, remat=False, mesh=None, attention_impl="auto", frozen=STAGE2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.value_and_grad(loss_fn)(params, jb, jax.random.PRNGKey(0))
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    mask = state.set_trainable(model, STAGE2)
    loss = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0, with_attention_mask=masked,
                                    length_aware=masked)(
        model, batch, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert model.wav2vec2.encoder.pos_conv_embed.conv.weight_v.grad is not None
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        if mask[name]:
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
            assert p.grad is not None or name == "wav2vec2.masked_spec_embed", name
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        else:
            assert p.grad is None and not want.any(), name


@pytest.mark.parametrize("masked", [False, True])
def test_xlarge_shaped_stage2_loss_and_grads_match_jax(masked):
    """`_stage2_matches_jax` at the 1280-d shape."""
    _stage2_matches_jax(XLARGE_TINY, 19, masked)


@pytest.mark.parametrize("masked", [False, True])
def test_xls_r_2b_shaped_stage2_loss_and_grads_match_jax(masked):
    """`_stage2_matches_jax` at XLS-R 2B's 1920-d shape (hidden 240, 2 heads
    of 120, pos conv 2 groups of 120)."""
    _stage2_matches_jax(XLS_R_2B_TINY, 29, masked)


# config.json architecture fields of the public 1280-d checkpoints
HUBERT_XLARGE = {  # facebook/hubert-xlarge-ls960-ft
    "model_type": "hubert", "architectures": ["HubertForCTC"], "vocab_size": 32,
    "hidden_size": 1280, "num_hidden_layers": 48, "num_attention_heads": 16,
    "intermediate_size": 5120, "hidden_act": "gelu", "conv_dim": [512] * 7,
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
    "feat_proj_layer_norm": True, "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5, "pad_token_id": 0,
    "apply_spec_augment": True, "mask_time_prob": 0.05, "mask_time_length": 10,
}
XLS_R_1B = {  # facebook/wav2vec2-xls-r-1b
    "model_type": "wav2vec2", "architectures": ["Wav2Vec2ForPreTraining"], "vocab_size": 32,
    "hidden_size": 1280, "num_hidden_layers": 48, "num_attention_heads": 16,
    "intermediate_size": 5120, "hidden_act": "gelu", "conv_dim": [512] * 7,
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
    "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16,
    "layer_norm_eps": 1e-5, "pad_token_id": 0, "apply_spec_augment": True,
    "mask_time_prob": 0.075, "mask_time_length": 10, "mask_feature_prob": 0.0,
    "mask_feature_length": 10, "num_codevector_groups": 2, "num_codevectors_per_group": 320,
    "codevector_dim": 1024, "proj_codevector_dim": 1024, "num_negatives": 100,
}
# facebook/wav2vec2-xls-r-2b: XLS-R 1B's fields at 1920-d (arXiv:2111.09296, Table 1)
XLS_R_2B = {**XLS_R_1B, "hidden_size": 1920, "intermediate_size": 7680}


@pytest.mark.parametrize("fields,cg", [(HUBERT_XLARGE, CG), (XLS_R_1B, CG), (XLS_R_2B, CG_2B)],
                         ids=["hubert_xlarge", "xls_r_1b", "xls_r_2b"])
def test_1280_d_configs_read_the_same_in_both_packages(fields, cg):
    """Both packages' `config_from_hf_dict` give the same robust config of
    the published fields, and it is the 80-channel geometry (120 at XLS-R
    2B): as many channels a pos-conv group as a head has."""
    want = jax_config.config_from_hf_dict(fields)
    got = port_config.config_from_hf_dict(fields)
    assert type(got).__name__ == type(want).__name__ == "RobustWav2Vec2Config"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hidden_size // got.num_conv_pos_embedding_groups == cg
    assert got.hidden_size // got.num_heads == cg and got.num_layers == 48


def test_1280_d_card_dispatch_takes_the_pos_conv_kernels_and_no_flash():
    """On the card the 1280-d family runs the pos-conv kernels' C/G = 80
    instances, and the plain attention at head dim 80 (JAX's flash kernels
    need d % 64 == 0 as well); in f32 neither kernel."""
    assert pos_conv.supports(1280, 16, torch.bfloat16, 128)
    assert not flash_attention.supports(80, torch.bfloat16)
    assert not pos_conv.supports(1280, 16, torch.float32, 128)
    assert pos_conv.dw_splits(128, CG, 16, 8, 768, 132) == 1


def test_1920_d_card_dispatch_takes_the_pos_conv_kernels_and_no_flash():
    """XLS-R 2B on the card: the pos-conv kernels' C/G = 120 instances, the
    plain attention at head dim 120; in f32 neither kernel."""
    assert pos_conv.supports(1920, 16, torch.bfloat16, 128)
    assert not flash_attention.supports(120, torch.bfloat16)
    assert not pos_conv.supports(1920, 16, torch.float32, 128)
    assert pos_conv.dw_splits(128, CG_2B, 16, 8, 768, 132) == 1
