"""The port's CTC fine-tuning step against the JAX package on the CPU.

A tiny f32 model (2 layers, 64 wide, 8000-sample inputs): the stage-2 and
stage-1 loss and gradients with dropout 0 and SpecAugment off against
`jax.value_and_grad` of JAX's loss with the same `frozen` subtrees (the
port's `set_trainable` with those names; also with a
ragged attention mask and length-aware CTC); the positional conv's
autograd function taken only where a gradient is needed; one Adam step
against optax
(also from an optax state carried across); gradient accumulation; EMA and
the learning-rate setters; the training forward against the eval forward;
the eval step; the unfrozen step (no frozen subtree, so the conv front end
trains through the plain layer loop).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.training import state as jax_state
from gsoc_wav2vec2_tpu.training import trainer as jax_trainer
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import adam_state_from_jax, params_from_jax
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv
from gsoc_wav2vec2_tpu_torch.training import state, trainer

torch.set_num_threads(2)
SEQLEN = 8000
STAGES = {"stage2": ("feature_extractor",), "stage1": ("wav2vec2",)}


def _pair(seed=0, **overrides):
    cfg = tiny_config(**overrides)
    params = jax_modeling.init_wav2vec2_for_ctc_params(jax.random.PRNGKey(seed), cfg)
    pcfg = port_config.Wav2Vec2Config(**dataclasses.asdict(cfg))
    model = modeling.Wav2Vec2ForCTC(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, params, pcfg, model


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    labels = np.zeros((b, 10), np.int32)
    for i in range(b):
        n = rng.integers(3, 8)
        labels[i, :n] = rng.integers(1, 32, size=n)
    return {"speech": rng.standard_normal((b, SEQLEN)).astype(np.float32), "labels": labels}


def _jax_loss_and_grads(cfg, params, batch, frozen, division_factor, masked=False):
    loss_fn = jax_trainer._make_ctc_loss_fn(
        cfg, division_factor=division_factor, with_attention_mask=masked, length_aware=masked,
        compute_dtype=jnp.float32, remat=False, mesh=None, attention_impl="auto", frozen=frozen)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(loss_fn)(params, jb, jax.random.PRNGKey(0))
    return float(loss), params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("stage,masked", [("stage1", False), ("stage2", False),
                                          ("stage2", True)])
def test_loss_and_grads_match_jax(stage, masked):
    """`masked`: a ragged attention mask and length-aware CTC lengths."""
    frozen = STAGES[stage]
    cfg, params, pcfg, model = _pair()
    batch = _batch()
    if masked:
        batch["attention_mask"] = np.ones((2, SEQLEN), np.int32)
        batch["attention_mask"][1, 6000:] = 0
    want_loss, want_grads = _jax_loss_and_grads(cfg, params, batch, frozen, 2.0, masked)

    mask = state.set_trainable(model, frozen)
    # JAX's mask has one bool per (layer-stacked) leaf: spread it over the leaf
    want_mask = params_from_jax(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m), jax_state.trainable_mask(params, frozen), params))
    assert mask == {n: bool(t.all()) for n, t in want_mask.items()}
    loss_fn = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0,
                                       with_attention_mask=masked, length_aware=masked)
    loss = loss_fn(model, batch, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert any(mask.values()) and not all(mask.values())
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        if mask[name]:
            # masked_spec_embed is unused with SpecAugment off: no grad here, zero in JAX
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
            assert p.grad is not None or name == "wav2vec2.masked_spec_embed", name
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        else:
            assert p.grad is None, name  # never built: requires_grad is off
            assert not want.any(), name  # JAX: zero behind stop_gradient


@pytest.mark.parametrize("robust", [False, True])
def test_unfrozen_loss_and_front_end_grads_match_jax(robust):
    """No frozen subtree (`set_trainable(model, ())`, JAX `frozen=()`): every
    leaf trains, conv0/conv1 included, and their gradients follow JAX's."""
    cfg = tiny_config(robust=robust)
    params = jax_modeling.init_wav2vec2_for_ctc_params(jax.random.PRNGKey(14), cfg)
    pcfg = (port_config.RobustWav2Vec2Config if robust else port_config.Wav2Vec2Config)(
        **dataclasses.asdict(cfg))
    model = modeling.Wav2Vec2ForCTC(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    batch = _batch(seed=15)
    want_loss, want_grads = _jax_loss_and_grads(cfg, params, batch, (), 2.0)
    mask = state.set_trainable(model, ())
    assert all(mask.values())
    loss = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0)(
        model, batch, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    front = [n for n in mask if "feature_extractor.conv_layers" in n]
    assert any(".0.conv.kernel" in n for n in front) and any(".1.conv.kernel" in n for n in front)
    for name, p in model.named_parameters():
        if name == "wav2vec2.masked_spec_embed":  # unused with SpecAugment off
            continue
        want = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4, err_msg=name)
        if name in front and name.endswith("kernel"):
            assert np.abs(want).sum() > 0, name


@pytest.mark.parametrize("robust", [False, True])
def test_bf16_front_end_takes_the_layer_loop_only_where_it_trains(monkeypatch, robust):
    """In bf16 a frozen front end goes through the fused conv0/conv1 function
    and a trainable one through the plain layer loop, which gives conv0 and
    conv1 their gradients; the two forwards agree to bf16 rounding."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend

    pcfg = (port_config.RobustWav2Vec2Config if robust else port_config.Wav2Vec2Config)(
        **dataclasses.asdict(tiny_config(robust=robust)))
    model = modeling.Wav2Vec2ForCTC(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    name = "fused_conv01_robust" if robust else "fused_conv01"
    fused = getattr(conv_frontend, name)
    seen = []
    monkeypatch.setattr(conv_frontend, name, lambda *a, **kw: seen.append(1) or fused(*a, **kw))
    x = torch.from_numpy(_batch(seed=16)["speech"])
    fe = model.wav2vec2.feature_extractor

    state.set_trainable(model, STAGES["stage2"])
    frozen = modeling.feature_encoder_forward(fe, pcfg, x, torch.bfloat16)
    assert len(seen) == 1 and not frozen.requires_grad
    state.set_trainable(model, ())
    with torch.no_grad():  # no gradient can reach conv0/conv1: the fused function again
        modeling.feature_encoder_forward(fe, pcfg, x, torch.bfloat16)
    assert len(seen) == 2
    trained = modeling.feature_encoder_forward(fe, pcfg, x, torch.bfloat16)
    assert len(seen) == 2 and trained.dtype == torch.bfloat16
    trained.float().square().sum().backward()
    for i in (0, 1):
        g = fe.conv_layers[i].conv.kernel.grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    scale = frozen.float().abs().max().item()
    assert (trained.float() - frozen.float()).abs().max().item() <= 0.05 * scale


@pytest.mark.parametrize("stage,calls", [("stage1", 0), ("stage2", 1)])
def test_pos_conv_autograd_function_only_where_a_gradient_is_needed(monkeypatch, stage, calls):
    """Stage 1's frozen backbone runs the forward kernel's path (no f32
    pre-activation kept); stage 2 goes through `PosConvTrain`."""
    _, _, pcfg, model = _pair(seed=12)
    apply = pos_conv.PosConvTrain.apply
    seen = []
    monkeypatch.setattr(pos_conv.PosConvTrain, "apply", lambda *a: seen.append(1) or apply(*a))
    state.set_trainable(model, STAGES[stage])
    loss = trainer.make_ctc_loss_fn(pcfg, division_factor=2.0)(
        model, _batch(seed=13), torch.Generator().manual_seed(0))
    loss.backward()
    assert len(seen) == calls
    assert (model.wav2vec2.encoder.pos_conv_embed.conv.weight_v.grad is not None) == bool(calls)


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


def _set_grads(model, grads):
    named = params_from_jax(grads)
    for name, p in model.named_parameters():
        p.grad = named[name].clone() if p.requires_grad else None


def _assert_params(model, params, atol=1e-6):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol, err_msg=name)


@pytest.mark.parametrize("dynamic_lr", [False, True])
def test_adam_step_matches_optax(dynamic_lr):
    """One masked Adam step (stage 2), then a second from the optax state
    carried into torch by `adam_state_from_jax`."""
    frozen = STAGES["stage2"]
    cfg, params, pcfg, model = _pair(seed=2)
    tx = jax_state.create_optimizer(1e-3, jax_state.trainable_mask(params, frozen),
                                    dynamic_lr=dynamic_lr)
    opt_state = tx.init(params)
    g1, g2 = _grads_like(params, 1), _grads_like(params, 2)
    updates, opt_state = tx.update(g1, opt_state, params)
    params1 = optax.apply_updates(params, updates)
    updates, _ = tx.update(g2, opt_state, params1)
    params2 = optax.apply_updates(params1, updates)

    state.set_trainable(model, frozen)
    opt = state.create_optimizer(model, 1e-3)
    _set_grads(model, g1)
    opt.step()
    _assert_params(model, params1)

    # a fresh model at params1, its Adam carried from optax
    _, _, _, model2 = _pair(seed=2)
    model2.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params1)))
    state.set_trainable(model2, frozen)
    opt2 = state.create_optimizer(model2, 1e-3)
    carried = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, opt_state), model2)
    assert len(carried) == len(opt2.param_groups[0]["params"])  # frozen leaves: no state
    opt2.state.update(carried)
    _set_grads(model2, g2)
    opt2.step()
    _assert_params(model2, params2)
    # and the first torch Adam continues the same way
    _set_grads(model, g2)
    opt.step()
    _assert_params(model, params2)


def test_learning_rate_setters_and_schedule_match_jax():
    cfg, params, pcfg, model = _pair()
    tx = jax_state.create_optimizer(1e-4, dynamic_lr=True)
    opt_state = jax_state.set_learning_rate(tx.init(params), 5e-5)
    state.set_trainable(model)
    opt = state.create_optimizer(model, 1e-4)
    state.set_learning_rate(opt, 5e-5)
    assert state.get_learning_rate(opt) == pytest.approx(jax_state.get_learning_rate(opt_state))
    want = jax_state.stage2_lr_schedule(1e-4, 5e-5, 10)
    got = state.stage2_lr_schedule(1e-4, 5e-5, 10)
    for step in (0, 9, 10, 11, 1000):
        assert got(step) == pytest.approx(float(want(step)))


def test_ema_update_matches_jax():
    _, params, _, model = _pair()
    rng = np.random.default_rng(3)
    ema = jax.tree_util.tree_map(lambda p: p + rng.standard_normal(p.shape).astype(np.float32),
                                 params)
    want = jax_trainer._ema_update(ema, params, 0.99)
    ema_t = params_from_jax(jax.tree_util.tree_map(np.asarray, ema))
    trainer.ema_update(ema_t, model, 0.99)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    for name in want:
        np.testing.assert_allclose(ema_t[name].numpy(), want[name].numpy(), atol=1e-6, err_msg=name)


def test_grad_accumulation_equals_one_double_batch():
    frozen = STAGES["stage2"]
    _, _, pcfg, model_a = _pair(seed=4)
    _, _, _, model_b = _pair(seed=4)
    batch = _batch(b=4, seed=5)
    halves = [{k: v[:2] for k, v in batch.items()}, {k: v[2:] for k, v in batch.items()}]
    gen = torch.Generator().manual_seed(0)

    state.set_trainable(model_a, frozen)
    st_a = state.create_train_state(model_a, state.create_optimizer(model_a, 1e-3))
    step = trainer.make_train_step(pcfg, division_factor=4.0)
    st_a, m_a = step(st_a, batch, gen)

    state.set_trainable(model_b, frozen)
    st_b = state.create_train_state(model_b, state.create_optimizer(model_b, 1e-3))
    init_fn, accum_fn, apply_fn = trainer.make_grad_accum_steps(pcfg, division_factor=4.0)
    loss = init_fn(st_b)
    for half in halves:
        loss = accum_fn(st_b, half, gen, loss)
    st_b, m_b = apply_fn(st_b, loss)

    assert st_a.step == st_b.step == 1
    np.testing.assert_allclose(m_b["loss"].item(), m_a["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m_b["grad_norm"].item(), m_a["grad_norm"].item(), rtol=1e-4)
    # the summed microbatch gradients are the big batch's (the updates are
    # not compared: Adam's first step turns the ~1e-9 noise of gradients that
    # are 0 in exact arithmetic, such as the key biases', into lr-sized moves)
    for (name, pa), (_, pb) in zip(model_a.named_parameters(), model_b.named_parameters()):
        if pa.grad is None:
            assert pb.grad is None, name
            continue
        np.testing.assert_allclose(pb.grad.numpy(), pa.grad.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_training_forward_without_dropout_equals_eval():
    _, _, pcfg, model = _pair(seed=6)
    x = torch.from_numpy(_batch(seed=7)["speech"])
    state.set_trainable(model, STAGES["stage2"])
    train = modeling.wav2vec2_for_ctc_forward(model, pcfg, x, training=True,
                                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ev = modeling.wav2vec2_for_ctc_forward(model, pcfg, x)
    torch.testing.assert_close(train.detach(), ev, rtol=0, atol=1e-6)


def test_training_forward_with_dropout_follows_the_generator():
    """Dropout 0.1 and SpecAugment on: the same generator seed gives the
    same logits, another seed others; frozen leaves get no gradient and
    every trainable one gets one."""
    _, _, pcfg, model = _pair(seed=8, dropout=0.1, apply_spec_augment=True,
                              mask_time_length=2)
    batch = _batch(seed=9)
    mask = state.set_trainable(model, STAGES["stage2"])
    opt = state.create_optimizer(model, 1e-3)
    st = state.create_train_state(model, opt, ema=True)
    step = trainer.make_train_step(pcfg, division_factor=2.0, ema_decay=0.9)
    x = torch.from_numpy(batch["speech"])

    def logits(seed):
        with torch.no_grad():
            return modeling.wav2vec2_for_ctc_forward(model, pcfg, x, training=True,
                                                     generator=torch.Generator().manual_seed(seed))

    assert torch.equal(logits(1), logits(1))
    assert not torch.allclose(logits(1), logits(2))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    st, metrics = step(st, batch, torch.Generator().manual_seed(3))
    assert np.isfinite(metrics["loss"].item()) and metrics["grad_norm"].item() > 0
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == mask[name], name
        assert (p.grad is not None) == mask[name], name
    assert st.step == 1 and not torch.equal(st.ema_params["lm_head.kernel"],
                                            model.lm_head.kernel.detach())


def test_eval_step_is_the_greedy_path():
    _, _, pcfg, model = _pair(seed=10)
    batch = _batch(seed=11)
    batch["attention_mask"] = np.ones((2, SEQLEN), np.int32)
    batch["attention_mask"][0, 5000:] = 0
    ids, lengths = trainer.make_eval_step(pcfg, with_attention_mask=True)(model, batch)
    with torch.no_grad():
        logits = modeling.wav2vec2_for_ctc_forward(
            model, pcfg, torch.from_numpy(batch["speech"]),
            torch.from_numpy(batch["attention_mask"]))
    assert ids.dtype == torch.int32 and torch.equal(ids, logits.argmax(-1).to(torch.int32))
    assert lengths.tolist() == [pcfg.conv_output_length(5000), pcfg.conv_output_length(SEQLEN)]
