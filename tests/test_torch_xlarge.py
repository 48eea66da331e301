"""The 1280-d family (HuBERT-xlarge, XLS-R 1B, MMS-1B) of the port against
the JAX package on the CPU.

These checkpoints are 1280 channels wide with 16 positional-conv groups and
16 heads: 80 channels a group, the width of the pos-conv kernels' C/G = 80
instances, and a head dim of 80, where neither package has a flash kernel.
Here: the pos conv's plain versions against JAX's Pallas kernels in
interpret mode at C/G = 80 (value and VJP), a tiny model of that shape
against the JAX model (logits, stage-2 loss and gradients), and both
packages' reading of the published configs.  Inputs come from numpy seeds.
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


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly, so that both packages start from
    the same bf16 operands."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _pos_conv_case(t, g=2, k=32, seed=0):
    c = g * CG
    rng = np.random.default_rng(seed + t)
    x = _bf16_exact(rng.standard_normal((2, t, c)))
    kernel = (rng.standard_normal((k, CG, c)) * (1.5 / np.sqrt(k * CG))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = _bf16_exact(rng.standard_normal((2, t, c)))
    return x, kernel, bias, dy, g, k


@pytest.mark.parametrize("t", [40, 37])
def test_pos_conv_plain_at_80_channels_a_group_matches_pallas(t):
    """`pos_conv_plain` and `pos_conv_train_fwd_plain`'s output against
    `pos_conv_fused` and `pos_conv_fused_train` in interpret mode at C/G = 80
    (g = 2, K = 32, an even and an odd T): the same bf16 operands and f32
    sums in another order, so the bf16 outputs agree to one bf16 ulp of
    their scale (2^-8 relative) and on average to 1e-3 of it."""
    x, kernel, bias, _, g, k = _pos_conv_case(t)
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
        assert a.shape == b.shape == (2, t, g * CG)
        assert diff.max() <= 2.0 ** -8 * scale and diff.mean() <= 1e-3 * scale
    # the kept pre-activation is GELU's input
    torch.testing.assert_close(torch.nn.functional.gelu(pre, approximate="tanh").to(torch.bfloat16),
                               got_train, rtol=0, atol=0)


@pytest.mark.parametrize("t", [40, 37])
def test_pos_conv_vjp_at_80_channels_a_group_matches_pallas(t):
    """dx and dW of `pos_conv_fused_train`'s `jax.vjp` (Pallas `_dx_call` and
    `_dw_call` in interpret mode) against the port's backward pieces at C/G =
    80: GELU' from `pos_conv_train_fwd_plain`'s pre-activation, dpre rounded
    to bf16 as both packages do, then `pos_conv_dx_plain` and
    `pos_conv_dw_plain`.  dx is bf16 (one bf16 ulp of its scale, mean 1e-3 of
    it); dW and db are f32 sums of the same bf16 products in another order
    (1e-5 of their scale)."""
    x, kernel, bias, dy, g, k = _pos_conv_case(t, seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def fwd(xv, kv, bv):
        return jax_pos_conv_train(xv, kv, bv, kernel_size=k, groups=g, gelu_approx=True,
                                  interpret=True)

    _, vjp = jax.vjp(fwd, xb, jnp.asarray(kernel), jnp.asarray(bias))
    want_dx, want_dw, want_db = (np.asarray(a, np.float32)
                                 for a in vjp(jnp.asarray(dy).astype(jnp.bfloat16)))

    xt = _t(x).to(torch.bfloat16)
    _, pre = pos_conv.pos_conv_train_fwd_plain(xt, _t(kernel), _t(bias), groups=g, gelu_approx=True)
    dpre = torch.ops.aten.gelu_backward(_t(dy), pre, approximate="tanh")
    db = dpre.sum(dim=(0, 1)).numpy()
    dpre = dpre.to(torch.bfloat16)
    dx = pos_conv.pos_conv_dx_plain(dpre, _t(kernel), groups=g)
    dw = pos_conv.pos_conv_dw_plain(xt, dpre, k, groups=g)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32 and dw.shape == (k, CG, g * CG)
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
    assert torch.equal(xin.grad, dx) and torch.equal(tk.grad, dw)


# a tiny model of the 1280-d shape: pos conv at 80 channels a group (2 groups
# of 160), head dim 80 (2 heads), stable-layer-norm layers, narrow convs
XLARGE_TINY = dict(hidden_size=2 * CG, num_heads=2, num_conv_pos_embedding_groups=2,
                   intermediate_size=4 * 2 * CG, num_layers=2, conv_bias=True)


def _xlarge_pair(seed):
    cfg = tiny_config(robust=True, **XLARGE_TINY)
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


def test_xlarge_shaped_logits_match_jax():
    """The tiny 1280-d-shaped model's logits against the f32 JAX forward with
    a ragged mask, at tests/test_torch_robust.py's tolerances: the port's f32
    forward atol 4e-3 (tests/test_parity.py's logits bound), its bf16 forward
    within 10% of the logit scale.  The head dim is 80 and C/G is 80."""
    cfg, params, pcfg, model = _xlarge_pair(seed=17)
    assert pcfg.hidden_size // pcfg.num_heads == CG
    assert pcfg.hidden_size // pcfg.num_conv_pos_embedding_groups == CG
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


@pytest.mark.parametrize("masked", [False, True])
def test_xlarge_shaped_stage2_loss_and_grads_match_jax(masked):
    """The tiny 1280-d-shaped model's stage-2 loss and gradients (conv stack
    frozen, f32) against `jax.value_and_grad`, at tests/test_torch_robust.py's
    tolerances: loss rtol 1e-5, gradients atol 1e-4."""
    cfg, params, pcfg, model = _xlarge_pair(seed=19)
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


@pytest.mark.parametrize("fields", [HUBERT_XLARGE, XLS_R_1B], ids=["hubert_xlarge", "xls_r_1b"])
def test_1280_d_configs_read_the_same_in_both_packages(fields):
    """Both packages' `config_from_hf_dict` give the same robust config of
    the published fields, and it is the 80-channel geometry."""
    want = jax_config.config_from_hf_dict(fields)
    got = port_config.config_from_hf_dict(fields)
    assert type(got).__name__ == type(want).__name__ == "RobustWav2Vec2Config"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hidden_size // got.num_conv_pos_embedding_groups == CG
    assert got.hidden_size // got.num_heads == CG and got.num_layers == 48


def test_1280_d_card_dispatch_takes_the_pos_conv_kernels_and_no_flash():
    """On the card the 1280-d family runs the pos-conv kernels' C/G = 80
    instances, and the plain attention at head dim 80 (JAX's flash kernels
    need d % 64 == 0 as well); in f32 neither kernel."""
    assert pos_conv.supports(1280, 16, torch.bfloat16, 128)
    assert not flash_attention.supports(80, torch.bfloat16)
    assert not pos_conv.supports(1280, 16, torch.float32, 128)
    assert pos_conv.dw_splits(128, CG, 16, 8, 768, 132) == 1
