"""The robust/large family of the port against the JAX package on the CPU.

The fused LayerNorm front end's plain version against the Pallas kernel in
interpret mode, the positional conv at 64 channels a group against Pallas,
the tiny robust model in bf16 (fused plain path) against the f32 JAX
forward, and the robust stage-2 loss and gradients against
`jax.value_and_grad`.  Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import build_pair

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.ops.conv import init_weight_g as jax_init_weight_g
from gsoc_wav2vec2_tpu.ops.conv import weight_norm_kernel as jax_weight_norm_kernel
from gsoc_wav2vec2_tpu.ops.pallas import conv_frontend as jax_cf
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused as jax_pos_conv
from gsoc_wav2vec2_tpu.ops.pallas.pos_conv import pos_conv_fused_train as jax_pos_conv_train
from gsoc_wav2vec2_tpu.training import state as jax_state
from gsoc_wav2vec2_tpu.training import trainer as jax_trainer
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import adam_state_from_jax, params_from_jax
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.ops.conv import weight_norm_kernel
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend, pos_conv
from gsoc_wav2vec2_tpu_torch.training import state, trainer

torch.set_num_threads(2)
SEQLEN = 8000


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _robust_frontend_inputs(length, c=128, seed=0):
    rng = np.random.default_rng(seed)
    vec = lambda scale, offset: (offset + scale * rng.standard_normal(c)).astype(np.float32)
    wave = rng.standard_normal((2, length)).astype(np.float32)
    w0 = (rng.standard_normal((10, 1, c)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((3, c, c)) * 0.05).astype(np.float32)
    # waveform, w0, b0, gamma0, beta0, w1, b1, gamma1, beta1
    return (wave, w0, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0),
            w1, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0))


@pytest.mark.parametrize("length", [26000, 24000])
def test_conv01_robust_plain_matches_pallas(length):
    """atol / rtol 0.05 and mean error 5e-3, the bounds the JAX package
    holds its own kernel to against XLA (tests/test_conv_frontend.py)."""
    args = _robust_frontend_inputs(length)
    want = np.asarray(
        jax_cf.fused_conv01_robust(*map(jnp.asarray, args), gelu_approx=True, interpret=True),
        np.float32,
    )
    got = conv_frontend.fused_conv01_robust(*map(_t, args), eps=1e-5, gelu_approx=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    assert np.abs(got - want).mean() < 5e-3


@pytest.mark.parametrize("norm,bias,ok", [("group", False, True), ("group", True, False),
                                          ("layer", True, True), ("layer", False, True)])
def test_supports_is_family_aware(norm, bias, ok):
    from gsoc_wav2vec2_tpu.models.config import Wav2Vec2Config as JaxConfig

    kw = dict(feature_extractor_norm_type=norm, conv_bias=bias, filter_sizes=[128] * 7)
    assert conv_frontend.fusable(port_config.Wav2Vec2Config(**kw)) is ok
    assert jax_cf.supports(JaxConfig(**kw), training=False) is ok
    # the card's kernels: the same families, at the widths of their instances
    # (every multiple of 128 up to 1024), not at a width without one
    wide = {**kw, "filter_sizes": [512] * 7}
    assert conv_frontend.supports(port_config.Wav2Vec2Config(**wide)) is ok
    assert conv_frontend.supports(port_config.Wav2Vec2Config(**kw)) is ok
    assert not conv_frontend.supports(port_config.Wav2Vec2Config(**{**kw, "filter_sizes": [192] * 7}))
    odd = port_config.Wav2Vec2Config(**{**wide, "strides": [4, 2, 2, 2, 2, 2, 2]})
    assert not conv_frontend.fusable(odd) and not conv_frontend.supports(odd)


def _pos_conv_inputs(t, c=256, g=4, k=128, seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, t, c)) * 0.5).astype(np.float32)
    wv = (rng.standard_normal((k, c // g, c)) * 0.05).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wg = np.asarray(jax_init_weight_g(jnp.asarray(wv)))
    return x, wv, wg, bias


@pytest.mark.parametrize("t", [256, 155])
def test_pos_conv_plain_at_64_channels_a_group_matches_pallas(t):
    """C / G = 64, the robust/large geometry (1024 / 16), at C = 256, G = 4."""
    c, g, k = 256, 4, 128
    x, wv, wg, bias = _pos_conv_inputs(t, c, g, k)
    kernel = np.asarray(jax_weight_norm_kernel(jnp.asarray(wv), jnp.asarray(wg)))
    assert kernel.shape[1] == 64
    want = np.asarray(
        jax_pos_conv(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(bias),
                     kernel_size=k, groups=g, gelu_approx=True, interpret=True),
        np.float32,
    )
    got = pos_conv.pos_conv(
        _t(x).to(torch.bfloat16), _t(kernel), _t(bias), groups=g, gelu_approx=True
    ).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    assert np.abs(got - want).mean() < 5e-3


def test_pos_conv_train_grads_at_64_channels_a_group_match_pallas():
    """PosConvTrain's x, weight_v, weight_g and bias gradients at C / G = 64
    against jax.grad through `pos_conv_fused_train` in interpret mode, at the
    tolerances of tests/test_pos_conv.py."""
    c, g, k, t = 256, 4, 128, 192
    x, wv, wg, bias = _pos_conv_inputs(t, c, g, k, seed=3)
    probe = np.random.default_rng(4).standard_normal((2, t, c)).astype(np.float32)

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


def _speech_and_mask(b=3, seed=2):
    speech = np.random.default_rng(seed).standard_normal((b, SEQLEN)).astype(np.float32)
    mask = np.zeros((b, SEQLEN), np.int64)
    for i, l in enumerate([SEQLEN, SEQLEN - 1700, SEQLEN - 3333][:b]):
        mask[i, :l] = 1
        speech[i, l:] = 0.0
    return speech, mask


def test_robust_bf16_fused_plain_path_tracks_f32_jax(monkeypatch):
    """The tiny robust model in bf16 on the CPU goes through
    `fused_conv01_robust`'s plain version (once a forward) and stays within
    bf16 noise (10% of the logit scale) of the f32 JAX forward, with a
    ragged mask."""
    cfg, params, pcfg, model = build_pair(True, seed=5)
    speech, mask = _speech_and_mask()
    want = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech), jnp.asarray(mask)))
    calls = []
    fused = conv_frontend.fused_conv01_robust
    monkeypatch.setattr(conv_frontend, "fused_conv01_robust",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    with torch.no_grad():
        got = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(speech), torch.from_numpy(mask),
            compute_dtype=torch.bfloat16).numpy()
        f32 = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(speech), torch.from_numpy(mask)).numpy()
    assert len(calls) == 1  # the f32 forward takes the unfused layers
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(f32, want, atol=4e-3)
    assert np.abs(got - want).max() < 0.1 * np.abs(want).max()


def test_robust_front_end_without_conv_bias_takes_zeros():
    """A layer-norm front end built without conv biases runs the fused path
    with zero biases, as the JAX forward does."""
    cfg = port_config.RobustWav2Vec2Config(
        vocab_size=32, hidden_size=64, num_heads=4, num_layers=1, intermediate_size=128,
        filter_sizes=[32] * 7, dropout=0.0, apply_spec_augment=False, conv_bias=False)
    model = modeling.Wav2Vec2Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    fe = model.feature_extractor
    assert fe.conv_layers[0].conv.bias is None
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, SEQLEN)).astype(np.float32))
    with torch.no_grad():
        fused = modeling.feature_encoder_forward(fe, cfg, x, torch.bfloat16).float()
        plain = modeling.feature_encoder_forward(fe, cfg, x, torch.float32)
    assert fused.shape == plain.shape
    assert (fused - plain).abs().max() < 0.1 * plain.abs().max()


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
def test_robust_stage2_loss_and_grads_match_jax(masked):
    """The robust stage-2 loss and gradients (pre-norm layers, LayerNorm conv
    stack frozen, f32) against `jax.value_and_grad`, as
    tests/test_torch_train_step.py does for base: loss rtol 1e-5, gradients
    atol 1e-4.  On the CPU `layer_norm` is `layer_norm_plain`, the JAX
    package's sequence; the card runs the fused `F.layer_norm`, which is
    not what this test holds (it is held against `layer_norm_plain` on the
    card instead: `test_torch_cuda.py`, `chip_smoke.py` phase 6b)."""
    cfg, params, pcfg, model = build_pair(True, seed=7)
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
    assert any(mask.values()) and not all(mask.values())
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        if mask[name]:
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
            assert p.grad is not None or name == "wav2vec2.masked_spec_embed", name
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        else:
            assert p.grad is None and not want.any(), name


def test_robust_adam_state_carries_over_from_optax():
    """`adam_state_from_jax` covers the robust tree: one optax Adam step on
    the stage-2 mask, carried into torch, continues to the same parameters."""
    import optax

    cfg, params, pcfg, model = build_pair(True, seed=8)
    rng = np.random.default_rng(9)
    rand_like = lambda: jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    g1, g2 = rand_like(), rand_like()
    tx = jax_state.create_optimizer(1e-3, jax_state.trainable_mask(params, STAGE2))
    opt_state = tx.init(params)
    updates, opt_state = tx.update(g1, opt_state, params)
    params1 = optax.apply_updates(params, updates)
    updates, _ = tx.update(g2, opt_state, params1)
    params2 = optax.apply_updates(params1, updates)

    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params1)))
    state.set_trainable(model, STAGE2)
    opt = state.create_optimizer(model, 1e-3)
    carried = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, opt_state), model)
    assert len(carried) == len(opt.param_groups[0]["params"])
    opt.state.update(carried)
    named = params_from_jax(g2)
    for name, p in model.named_parameters():
        p.grad = named[name].clone() if p.requires_grad else None
    opt.step()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params2))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, err_msg=name)
