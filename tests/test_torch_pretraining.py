"""The port's self-supervised pretraining against the JAX package on the CPU.

Tiny f32 models (`tiny_pretraining_config`, base and robust), inputs from
numpy seeds, weights carried by `params_from_jax`.  Random draws cannot match
across the two frameworks, so where a draw matters the port's two draw
functions (`_gumbel_noise`, `_uniform_below`) are replaced by the arrays JAX
drew from the same key.  Held here: the eval forward, the training quantizer
and its straight-through gradients, the negative sampler, both contrastive
formulations and the scatter wrapper behind `gather`, rows whose negatives
are all masked, one `make_pretrain_step` update against optax `adamw` under
the warmup schedule, gradient accumulation, the CTC hand-over, the JAX and HF
bridges and the pretraining CLI's helpers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.utils import matching_hf_config, requires_transformers, tiny_pretraining_config

from gsoc_wav2vec2_tpu.cli import pretrain as jax_cli
from gsoc_wav2vec2_tpu.models import pretraining as jp
from gsoc_wav2vec2_tpu.training.state import TrainState as JaxTrainState
from gsoc_wav2vec2_tpu_torch.cli import pretrain as cli
from gsoc_wav2vec2_tpu_torch.convert.hf_torch import hf_name_map
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import (
    adam_state_from_jax,
    params_from_jax,
    params_to_jax,
)
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import pretraining as pt
from gsoc_wav2vec2_tpu_torch.ops.kernels import scatter_add
from gsoc_wav2vec2_tpu_torch.training import state as port_state

torch.set_num_threads(2)
SAMPLES = 6400  # 19 frames


def _port_config(cfg):
    cls = (port_config.RobustWav2Vec2PretrainingConfig if cfg.is_robust
           else port_config.Wav2Vec2PretrainingConfig)
    return cls(**dataclasses.asdict(cfg))


def _pair(robust=False, seed=0, **overrides):
    cfg = tiny_pretraining_config(robust=robust, **overrides)
    params = jp.init_wav2vec2_for_pretraining_params(jax.random.PRNGKey(seed), cfg)
    pcfg = _port_config(cfg)
    model = pt.Wav2Vec2ForPreTraining(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, params, pcfg, model


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b=2, seed=0, ragged=False):
    """Speech, a span-free random frame mask with at least two masked real
    frames a row, and (ragged) a sample mask that cuts row 1 short."""
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((b, SAMPLES)).astype(np.float32)
    frames = int(cfg.conv_output_length(SAMPLES))
    mti = rng.random((b, frames)) < 0.5
    mti[:, :2] = True
    batch = {"speech": speech, "mask_time_indices": mti}
    if ragged:
        am = np.ones((b, SAMPLES), np.int32)
        am[1, 4000:] = 0
        speech[1, 4000:] = 0.0
        mti[1, int(cfg.conv_output_length(4000)):] = False
        batch["attention_mask"] = am
    return batch


# ---------------------------------------------------------------------------
# forward, quantizer, sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robust,ragged", [(False, False), (True, False), (True, True)])
def test_eval_forward_matches_jax(robust, ragged):
    cfg, params, pcfg, model = _pair(robust, seed=1)
    batch = _batch(cfg, seed=2, ragged=ragged)
    am = batch.get("attention_mask")
    want = jp.wav2vec2_for_pretraining_forward(
        params, cfg, jnp.asarray(batch["speech"]), jnp.asarray(batch["mask_time_indices"]),
        None if am is None else jnp.asarray(am), return_code_ids=True)
    with torch.no_grad():
        got = pt.wav2vec2_for_pretraining_forward(
            model, pcfg, torch.from_numpy(batch["speech"]),
            torch.from_numpy(batch["mask_time_indices"]),
            None if am is None else torch.from_numpy(am), return_code_ids=True)
    states, quantized, perplexity, ids = got
    assert states.dtype == quantized.dtype == torch.float32 and ids.dtype == torch.int32
    np.testing.assert_allclose(states.numpy(), np.asarray(want[0]), atol=2e-4)
    np.testing.assert_allclose(quantized.numpy(), np.asarray(want[1]), atol=2e-5)
    np.testing.assert_allclose(perplexity.item(), float(want[2]), rtol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[3]))
    # the module's own forward is this eval forward, without the ids
    with torch.no_grad():
        three = model(torch.from_numpy(batch["speech"]), torch.from_numpy(batch["mask_time_indices"]),
                      None if am is None else torch.from_numpy(am))
    assert len(three) == 3 and torch.equal(three[0], states) and torch.equal(three[1], quantized)


@pytest.mark.parametrize("masked", [False, True])
def test_perplexity_matches_jax(masked):
    rng = np.random.default_rng(3)
    probs = rng.random((30, 2, 16)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    mask = (rng.random(30) < 0.4) if masked else None
    want = jp._perplexity(jnp.asarray(probs), None if mask is None else jnp.asarray(mask))
    got = pt._perplexity(torch.from_numpy(probs), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _jax_noise(monkeypatch, key):
    """The port's Gumbel noise becomes what JAX draws from `key`."""
    monkeypatch.setattr(pt, "_gumbel_noise", lambda generator, shape, device: torch.tensor(
        np.asarray(jax.random.gumbel(key, tuple(shape), jnp.float32))))


@pytest.mark.parametrize("masked", [False, True])
def test_training_quantizer_matches_jax_with_its_noise(monkeypatch, masked):
    """Hard one-hots forward, soft gradients: output, ids, perplexity and
    the gradients to `weight_proj` and the codebooks."""
    cfg, params, pcfg, model = _pair(seed=4)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = (rng.random((2, 9)) < 0.5) if masked else None
    key = jax.random.PRNGKey(7)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(p):
        q, perp, ids = jp.gumbel_vector_quantizer(
            p, cfg, jnp.asarray(feats), jmask, temperature=1.5, training=True, rng=key)
        return jnp.sum(q * q) + perp, (q, perp, ids)

    (_, (want_q, want_perp, want_ids)), want_grads = jax.value_and_grad(f, has_aux=True)(
        params["quantizer"])

    _jax_noise(monkeypatch, key)
    model.quantizer.requires_grad_(True)
    q, perp, ids = pt.gumbel_vector_quantizer(
        model.quantizer, pcfg, torch.from_numpy(feats),
        None if mask is None else torch.from_numpy(mask), temperature=1.5, training=True,
        generator=torch.Generator().manual_seed(0))
    ((q * q).sum() + perp).backward()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(want_q), atol=1e-5)
    np.testing.assert_allclose(perp.item(), float(want_perp), rtol=1e-5)
    wp = model.quantizer.weight_proj
    np.testing.assert_allclose(wp.kernel.grad.numpy(), np.asarray(want_grads["weight_proj"]["kernel"]),
                               atol=1e-5)
    np.testing.assert_allclose(wp.bias.grad.numpy(), np.asarray(want_grads["weight_proj"]["bias"]),
                               atol=1e-5)
    np.testing.assert_allclose(model.quantizer.codevectors.grad.numpy(),
                               np.asarray(want_grads["codevectors"]), atol=1e-5)
    assert wp.kernel.grad.abs().sum() > 0 and model.quantizer.codevectors.grad.abs().sum() > 0


def test_training_quantizer_needs_a_generator_and_its_noise_is_gumbel():
    _, _, pcfg, model = _pair(seed=4)
    with pytest.raises(ValueError, match="generator"):
        pt.gumbel_vector_quantizer(model.quantizer, pcfg, torch.zeros(1, 3, 32), None, training=True)
    noise = pt._gumbel_noise(torch.Generator().manual_seed(1), (200000,), torch.device("cpu"))
    assert torch.isfinite(noise).all()
    # standard Gumbel: mean = Euler's constant, variance = pi^2 / 6
    assert abs(noise.mean().item() - 0.5772) < 0.02 and abs(noise.var().item() - 1.6449) < 0.05


def _masks(b, l, seed, p=0.4):
    mask = np.random.default_rng(seed).random((b, l)) < p
    mask[:, :2] = True
    return mask


def _jax_negatives(key, mask, k):
    return np.asarray(jp.sample_negative_indices(key, jnp.asarray(mask), k))


def _jax_uniform(monkeypatch, key):
    """The port's uniform integers become what JAX's sampler draws from `key`."""
    def below(generator, shape, high):
        bound = jnp.asarray(high.numpy().astype(np.int32)).reshape(-1, *([1] * (len(shape) - 1)))
        return torch.tensor(np.asarray(jax.random.randint(key, tuple(shape), 0, bound))).long()
    monkeypatch.setattr(pt, "_uniform_below", below)


@pytest.mark.parametrize("case", ["random", "one_masked_frame", "no_masked_frame"])
def test_sample_negative_indices_equal_jax_for_its_draws(monkeypatch, case):
    b, l, k = 3, 64, 20
    mask = _masks(b, l, seed=0)
    if case == "one_masked_frame":
        mask[1] = False
        mask[1, 5] = True
    elif case == "no_masked_frame":
        mask[2] = False
    key = jax.random.PRNGKey(11)
    _jax_uniform(monkeypatch, key)
    got = pt.sample_negative_indices(torch.Generator().manual_seed(0), torch.from_numpy(mask), k)
    assert got.dtype == torch.int32 and got.shape == (b, l, k)
    np.testing.assert_array_equal(got.numpy(), _jax_negatives(key, mask, k))


def test_sample_negative_indices_properties_with_the_ports_generator():
    """Every negative of a masked frame is another masked frame of the same
    utterance, unmasked frames get in-row index 0, coverage is near-uniform,
    and the draws follow the generator."""
    b, l, k = 3, 64, 20
    mask = _masks(b, l, seed=0)
    negs = pt.sample_negative_indices(
        torch.Generator().manual_seed(0), torch.from_numpy(mask), k).numpy()
    for bi in range(b):
        masked_pos = set(np.flatnonzero(mask[bi]))
        for li in range(l):
            row = negs[bi, li] - bi * l
            if not mask[bi, li]:
                assert not row.any()
                continue
            assert (row >= 0).all() and (row < l).all()
            assert li not in row, "sampled the positive itself"
            assert set(row.tolist()) <= masked_pos, "negative not masked"
    seen = set()
    for li in np.flatnonzero(mask[0]):
        seen |= set(negs[0, li].tolist())
    assert len(seen) >= 0.8 * mask[0].sum()
    again = pt.sample_negative_indices(
        torch.Generator().manual_seed(0), torch.from_numpy(mask), k).numpy()
    other = pt.sample_negative_indices(
        torch.Generator().manual_seed(1), torch.from_numpy(mask), k).numpy()
    assert np.array_equal(negs, again) and not np.array_equal(negs, other)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def _loss_inputs(seed=21, b=2, l=48, collide=False):
    cfg = tiny_pretraining_config()
    rng = np.random.default_rng(seed)
    d = cfg.proj_codevector_dim
    states = rng.standard_normal((b, l, d)).astype(np.float32)
    quantized = rng.standard_normal((b, l, d)).astype(np.float32)
    mti = rng.random((b, l)) < 0.5
    mti[:, :2] = True
    negs = _jax_negatives(jax.random.PRNGKey(seed), mti, cfg.num_negatives)
    # a tiny codebook: real id collisions, so some negatives are masked to -inf
    code_ids = rng.integers(0, 3, size=(b, l, cfg.num_codevector_groups)).astype(np.int32)
    if collide:
        code_ids[:] = 1  # every negative carries its target's codewords
    return cfg, states, quantized, mti, negs, code_ids


def _jax_loss(cfg, states, quantized, mti, negs, code_ids, impl):
    def loss(s, q):
        parts = jp.pretraining_loss(
            s, q, jnp.float32(5.0), jnp.asarray(mti), jnp.asarray(negs), cfg,
            code_ids=None if code_ids is None else jnp.asarray(code_ids),
            pallas_scatter=None if impl == "gram" else False, contrastive_impl=impl)
        return parts["loss"], parts

    (_, parts), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(states), jnp.asarray(quantized))
    return {k: float(v) for k, v in parts.items()}, [np.asarray(g) for g in grads]


def _port_loss(cfg, states, quantized, mti, negs, code_ids, impl, kernel):
    s = torch.from_numpy(states).requires_grad_()
    q = torch.from_numpy(quantized).requires_grad_()
    parts = pt.pretraining_loss(
        s, q, torch.tensor(5.0), torch.from_numpy(mti), torch.tensor(negs), _port_config(cfg),
        code_ids=None if code_ids is None else torch.from_numpy(code_ids),
        scatter_kernel=kernel, contrastive_impl=impl)
    parts["loss"].backward()
    return {k: v.item() for k, v in parts.items()}, [s.grad.numpy(), q.grad.numpy()]


VARIANTS = {
    # name: (contrastive_impl, scatter_kernel, with code_ids, the JAX formulation held against)
    "gram": ("gram", None, True, "gram"),
    "auto_is_gram": ("auto", None, True, "gram"),
    "gather_autograd": ("gather", False, True, "gather"),
    "gather_without_code_ids": ("gather", False, False, "gather"),
    "auto_without_code_ids_is_gather": ("auto", None, False, "gather"),
    "gather_scatter_wrapper": ("gather", True, True, "gather"),
    "auto_with_the_wrapper_forced_is_gather": ("auto", True, True, "gather"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pretraining_loss_and_input_gradients_match_jax(variant, monkeypatch):
    impl, kernel, with_ids, jax_impl = VARIANTS[variant]
    cfg, states, quantized, mti, negs, code_ids = _loss_inputs()
    ids = code_ids if with_ids else None
    calls = []
    plain = scatter_add.scatter_rows_add
    monkeypatch.setattr(scatter_add, "scatter_rows_add",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    want_parts, want_grads = _jax_loss(cfg, states, quantized, mti, negs, ids, jax_impl)
    got_parts, got_grads = _port_loss(cfg, states, quantized, mti, negs, ids, impl, kernel)
    for name, want in want_parts.items():
        np.testing.assert_allclose(got_parts[name], want, rtol=2e-4, err_msg=name)
    for got, want, name in zip(got_grads, want_grads, ("states", "quantized")):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
    # the gather's backward goes through the scatter wrapper unless it is switched off
    uses_wrapper = jax_impl == "gather" and kernel is not False
    assert len(calls) == int(uses_wrapper)


def test_gram_matches_gather_in_the_port():
    cfg, states, quantized, mti, negs, code_ids = _loss_inputs(seed=22)
    gram = _port_loss(cfg, states, quantized, mti, negs, code_ids, "gram", None)
    gather = _port_loss(cfg, states, quantized, mti, negs, code_ids, "gather", False)
    wrapper = _port_loss(cfg, states, quantized, mti, negs, code_ids, "gather", None)
    np.testing.assert_allclose(gram[0]["loss"], gather[0]["loss"], rtol=1e-5)
    assert wrapper[0]["loss"] == gather[0]["loss"]  # the same forward
    for a, w, k in zip(gram[1], wrapper[1], gather[1]):
        np.testing.assert_allclose(a, k, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(w, k, rtol=1e-5, atol=1e-6)


def test_pretraining_loss_refuses_what_jax_refuses():
    cfg, states, quantized, mti, negs, _ = _loss_inputs()
    args = (torch.from_numpy(states), torch.from_numpy(quantized), torch.tensor(5.0),
            torch.from_numpy(mti), torch.tensor(negs), _port_config(cfg))
    with pytest.raises(ValueError, match="requires code_ids"):
        pt.pretraining_loss(*args, contrastive_impl="gram")
    with pytest.raises(ValueError, match="unknown contrastive_impl"):
        pt.pretraining_loss(*args, contrastive_impl="dense")


@pytest.mark.parametrize("impl,kernel", [("gram", None), ("gather", False), ("gather", True)])
def test_rows_whose_negatives_are_all_masked_keep_every_gradient_finite(impl, kernel):
    """Every frame carries the same codewords, so all K negatives of every
    row are -inf: log Z is the positive, the contrastive loss is 0, and the
    gradients are finite (0 through the contrastive part), as in JAX."""
    cfg, states, quantized, mti, negs, code_ids = _loss_inputs(seed=23, collide=True)
    want_parts, want_grads = _jax_loss(cfg, states, quantized, mti, negs, code_ids, impl)
    got_parts, got_grads = _port_loss(cfg, states, quantized, mti, negs, code_ids, impl, kernel)
    assert got_parts["contrastive_loss"] == 0.0 == want_parts["contrastive_loss"]
    np.testing.assert_allclose(got_parts["loss"], want_parts["loss"], rtol=1e-6)
    for got, want in zip(got_grads, want_grads):
        assert np.isfinite(got).all() and np.isfinite(want).all()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_unmasked_frames_with_all_negatives_masked_do_not_poison_masked_rows():
    """The sampler's own case: an unmasked frame's negatives all point at
    frame 0; where its codewords equal frame 0's the whole row is -inf and is
    multiplied by mask 0."""
    cfg, states, quantized, mti, negs, code_ids = _loss_inputs(seed=24)
    mti[:, 0] = False  # frame 0 is unmasked: its negatives are K copies of itself
    negs = _jax_negatives(jax.random.PRNGKey(24), mti, cfg.num_negatives)
    assert (negs[0, 0] == 0).all()
    for impl, kernel in (("gram", None), ("gather", True)):
        want_parts, want_grads = _jax_loss(cfg, states, quantized, mti, negs, code_ids, impl)
        got_parts, got_grads = _port_loss(cfg, states, quantized, mti, negs, code_ids, impl, kernel)
        np.testing.assert_allclose(got_parts["loss"], want_parts["loss"], rtol=2e-4)
        for got, want in zip(got_grads, want_grads):
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

LR, WARMUP, TOTAL = 2e-3, 2, 10


def _jax_tx():
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, LR, WARMUP), optax.linear_schedule(LR, 0.0, TOTAL - WARMUP)],
        [WARMUP])
    return schedule, optax.adamw(schedule, weight_decay=0.01, eps=1e-6)


def _jax_step_keys(rng, step):
    """(Gumbel key, negatives key) of JAX's pretraining step `step`: the
    step folds the count in and splits; the forward's fourth key is the noise."""
    rng_fwd, rng_neg = jax.random.split(jax.random.fold_in(rng, step))
    for _ in range(4):  # projection dropout, encoder, quantizer dropout, Gumbel
        rng_fwd, sub = jax.random.split(rng_fwd)
    return sub, rng_neg


def _assert_params(model, tree, atol, lr):
    """The key biases' gradient is 0 in exact arithmetic (softmax ignores a
    shift of every key's score), so AdamW turns its ~1e-7 noise into moves of
    up to the learning rate on either side: those are held to that only."""
    want = params_from_jax(_np_tree(tree))
    for name, p in model.named_parameters():
        tol = 2 * lr if name.endswith("k_proj.bias") else atol
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=tol, err_msg=name)


@pytest.mark.parametrize("robust", [False, True])
def test_pretrain_step_matches_jax_and_optax(monkeypatch, robust):
    """Two updates at dropout 0 with JAX's noise and negatives: the first at
    the schedule's learning rate 0 (optax counts from 0), the second not.
    The robust case runs with the ragged attention mask."""
    cfg, params, pcfg, model = _pair(robust, seed=6)
    batch = _batch(cfg, seed=7, ragged=robust)
    b = batch["speech"].shape[0]
    _, tx = _jax_tx()
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    jstep = jp.make_pretrain_step(cfg, tx, division_factor=b, with_attention_mask=robust,
                                  compute_dtype=jnp.float32, remat=False)
    rng = jax.random.PRNGKey(9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    port_state.set_trainable(model, ())
    state = port_state.create_train_state(model, port_state.create_pretrain_optimizer(model, 0.0))
    schedule = port_state.pretrain_lr_schedule(LR, WARMUP, TOTAL)
    step = pt.make_pretrain_step(pcfg, division_factor=b, with_attention_mask=robust)
    gen = torch.Generator().manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    opt_states = []
    for i in range(2):
        noise_key, neg_key = _jax_step_keys(rng, i)
        jstate, want = jstep(jstate, jbatch, rng, jnp.float32(2.0))
        opt_states.append(_np_tree(jstate.opt_state))
        _jax_noise(monkeypatch, noise_key)
        _jax_uniform(monkeypatch, neg_key)
        port_state.set_learning_rate(state.optimizer, schedule(state.step))
        state, got = step(state, batch, gen, 2.0)
        assert state.step == i + 1
        for name in ("loss", *pt.PART_NAMES):
            np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-4, err_msg=name)
        assert np.isfinite(got["grad_norm"].item()) and got["grad_norm"].item() > 0
        _assert_params(model, jstate.params, atol=1e-5, lr=schedule(i))
        moved = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])]
        # learning rate 0 moves nothing; the second update moves every parameter
        assert len(moved) == (0 if i == 0 else len(before)), (i, len(moved))
    fe = model.wav2vec2.feature_extractor.conv_layers
    assert fe[0].conv.kernel.grad.abs().sum() > 0 and fe[1].conv.kernel.grad.abs().sum() > 0

    # the AdamW moments of optax's state after update 1 are what torch holds
    carried = adam_state_from_jax(opt_states[1], model)
    assert len(carried) == len(list(model.parameters()))
    for p, want in carried.items():
        have = state.optimizer.state[p]
        assert have["step"].item() == want["step"].item() == 2.0
        np.testing.assert_allclose(have["exp_avg"].numpy(), want["exp_avg"].numpy(), atol=1e-5)
        np.testing.assert_allclose(have["exp_avg_sq"].numpy(), want["exp_avg_sq"].numpy(), atol=1e-5)


@pytest.mark.parametrize("count", [0, 1, 2, 3, 6, 10, 11, 500])
def test_pretrain_lr_schedule_matches_optax(count):
    schedule, _ = _jax_tx()
    got = port_state.pretrain_lr_schedule(LR, WARMUP, TOTAL)
    assert got(count) == pytest.approx(float(schedule(count)), rel=1e-6, abs=1e-12)
    # warmup_steps 0 and a horizon inside the warmup are clamped as the JAX CLI clamps them
    flat = optax.join_schedules([optax.linear_schedule(0.0, LR, 1), optax.linear_schedule(LR, 0.0, 1)], [1])
    assert port_state.pretrain_lr_schedule(LR, 0, 0)(count) == pytest.approx(
        float(flat(count)), rel=1e-6, abs=1e-12)


def test_pretrain_optimizer_is_adamw_over_every_parameter():
    _, _, _, model = _pair(seed=8)
    with pytest.raises(ValueError, match="set_trainable"):
        port_state.create_pretrain_optimizer(model, 1e-3)
    mask = port_state.set_trainable(model, ())
    assert all(mask.values())
    opt = port_state.create_pretrain_optimizer(model, 1e-3)
    assert isinstance(opt, torch.optim.AdamW)
    (group,) = opt.param_groups
    assert len(group["params"]) == len(mask)  # biases and norms decay too, as in optax.adamw
    assert group["eps"] == 1e-6 and group["weight_decay"] == 0.01 and group["betas"] == (0.9, 0.999)


def test_accumulation_over_two_microbatches_sums_the_gradients():
    """`accum_fn` twice = the two microbatches' gradients and loss parts
    summed (the draws follow the one generator in both runs), and `apply_fn`
    is one optimizer update."""
    cfg, _, pcfg, model = _pair(seed=10, dropout=0.1)
    micros = [_batch(cfg, seed=s) for s in (11, 12)]
    port_state.set_trainable(model, ())
    state = port_state.create_train_state(model, port_state.create_pretrain_optimizer(model, 1e-3))
    init_fn, accum_fn, apply_fn = pt.make_pretrain_accum_steps(pcfg, division_factor=4.0)
    loss_fn = pt._make_pretrain_loss_fn(pcfg, division_factor=4.0, with_attention_mask=False,
                                        compute_dtype=None)

    gen = torch.Generator().manual_seed(5)
    want_grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    want = {k: 0.0 for k in ("loss", *pt.PART_NAMES)}
    for mb in micros:
        model.zero_grad(set_to_none=True)
        loss, parts = loss_fn(model, mb, gen, 1.7)
        loss.backward()
        for n, p in model.named_parameters():
            want_grads[n] += p.grad
        for k in want:
            want[k] += (loss if k == "loss" else parts[k]).item()

    gen = torch.Generator().manual_seed(5)
    metrics = init_fn(state)
    assert all(p.grad is None for p in model.parameters())
    for mb in micros:
        metrics = accum_fn(state, mb, gen, 1.7, metrics)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, out = apply_fn(state, metrics)
    assert state.step == 1
    for k, v in want.items():
        np.testing.assert_allclose(out[k].item(), v, rtol=1e-5, err_msg=k)
    assert out["grad_norm"].item() > 0
    assert all(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())


def test_pretrain_step_follows_the_generator_and_learns():
    """Dropout 0.1, the port's own draws: the same generator seed gives the
    same loss, another seed another; ten updates on fixed data lower the
    contrastive loss; the EMA shadow follows."""
    cfg, _, pcfg, model = _pair(seed=13, dropout=0.1, num_layers=1)
    batch = _batch(cfg, seed=14)
    loss_fn = pt._make_pretrain_loss_fn(pcfg, division_factor=2.0, with_attention_mask=False,
                                        compute_dtype=None)

    def loss(seed):
        with torch.no_grad():
            return loss_fn(model, batch, torch.Generator().manual_seed(seed), 2.0)[0].item()

    assert loss(1) == loss(1) and loss(1) != loss(2)
    port_state.set_trainable(model, ())
    state = port_state.create_train_state(
        model, port_state.create_pretrain_optimizer(model, 3e-3), ema=True)
    step = pt.make_pretrain_step(pcfg, division_factor=2.0, ema_decay=0.9)
    gen = torch.Generator().manual_seed(3)
    losses = []
    for i in range(10):
        state, m = step(state, batch, gen, cli.gumbel_temperature(cli.PretrainingArgs(), i))
        losses.append(m["contrastive_loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0], losses
    name = "quantizer.codevectors"
    assert not torch.equal(state.ema_params[name], model.quantizer.codevectors.detach())


# ---------------------------------------------------------------------------
# hand-over, bridges, the pretraining CLI's helpers
# ---------------------------------------------------------------------------


def test_ctc_model_from_pretraining_runs_and_keeps_the_backbone():
    cfg, params, pcfg, model = _pair(seed=15)
    ctc = pt.ctc_params_from_pretraining(model, pcfg, torch.Generator().manual_seed(1))
    assert not any(p.requires_grad for p in ctc.parameters())
    for name, t in model.wav2vec2.state_dict().items():
        assert torch.equal(ctc.wav2vec2.state_dict()[name], t), name
    other = pt.ctc_params_from_pretraining(model, pcfg, torch.Generator().manual_seed(2))
    assert not torch.equal(ctc.lm_head.kernel, other.lm_head.kernel)  # a fresh head from the generator
    speech = torch.from_numpy(_batch(cfg, seed=16)["speech"])
    with torch.no_grad():
        logits = ctc(speech)
    assert logits.shape == (2, int(cfg.conv_output_length(SAMPLES)), cfg.vocab_size)
    assert torch.isfinite(logits).all()
    # the same backbone as JAX's hand-over
    jtree = jp.ctc_params_from_pretraining(params, cfg, jax.random.PRNGKey(0))
    want = params_from_jax(_np_tree(jtree["wav2vec2"]))
    for name, t in ctc.wav2vec2.state_dict().items():
        assert torch.equal(t, want[name]), name


def _equal_trees(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("robust", [False, True])
def test_bridge_round_trip_of_the_pretraining_tree_is_bit_exact(robust):
    _, params, _, model = _pair(robust, seed=17)
    tree = _np_tree(params)
    sd = params_from_jax(tree)
    assert {"quantizer.codevectors", "quantizer.weight_proj.kernel", "quantizer.weight_proj.bias",
            "project_hid.kernel", "project_q.bias"} <= set(sd)
    assert set(sd) == set(model.state_dict())
    _equal_trees(params_to_jax(sd), tree)
    _equal_trees(params_to_jax(model.state_dict()), tree)


def test_initialisation_follows_the_jax_distributions():
    """Codebooks U[0, 1), `weight_proj` N(0, 1) with zero bias, glorot heads,
    the leaves of JAX's tree with its shapes; weights follow the generator."""
    cfg, params, pcfg, _ = _pair(seed=18)
    model = pt.Wav2Vec2ForPreTraining(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    want = params_from_jax(_np_tree(params))
    assert {n: tuple(t.shape) for n, t in sd.items()} == {n: tuple(t.shape) for n, t in want.items()}
    cv = sd["quantizer.codevectors"]
    assert cv.min() >= 0 and cv.max() < 1 and abs(cv.mean().item() - 0.5) < 0.05
    wp = sd["quantizer.weight_proj.kernel"]
    assert abs(wp.mean().item()) < 0.1 and abs(wp.std().item() - 1.0) < 0.1
    assert not sd["quantizer.weight_proj.bias"].any()
    for name in ("project_hid", "project_q"):
        k = sd[f"{name}.kernel"]
        limit = (6.0 / sum(k.shape)) ** 0.5
        assert k.abs().max() <= limit and k.abs().max() > 0.8 * limit
        assert not sd[f"{name}.bias"].any()
    assert not any(p.requires_grad for p in model.parameters())
    again = pt.Wav2Vec2ForPreTraining(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(t, again.state_dict()[n]) for n, t in sd.items())
    with pytest.raises(ValueError, match="Wav2Vec2PretrainingConfig"):
        pt.Wav2Vec2ForPreTraining(port_config.Wav2Vec2Config(), device="cpu")


def test_hf_name_map_covers_the_pretraining_heads():
    _, _, pcfg, model = _pair(seed=19)
    names = hf_name_map(pcfg, with_lm_head=False, prefix="wav2vec2.", pretraining=True)
    assert set(model.state_dict()) - {"wav2vec2.masked_spec_embed"} <= set(names)
    assert names["quantizer.codevectors"][0] == "quantizer.codevectors"
    assert names["quantizer.weight_proj.kernel"][0] == "quantizer.weight_proj.weight"
    assert names["project_hid.bias"][0] == "project_hid.bias"
    assert names["project_q.kernel"][0] == "project_q.weight"
    assert "lm_head.kernel" not in names


@requires_transformers
def test_from_pretrained_hf_pretraining_checkpoint_matches_jax(tmp_path):
    import transformers

    from gsoc_wav2vec2_tpu.convert.torch_to_jax import pretraining_params_from_hf_model

    cfg = tiny_pretraining_config()
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2ForPreTraining(matching_hf_config(cfg)).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=False)
    model = pt.Wav2Vec2ForPreTraining.from_pretrained(str(tmp_path), device="cpu")
    assert isinstance(model.config, port_config.Wav2Vec2PretrainingConfig)
    assert model.config.num_codevectors_per_group == cfg.num_codevectors_per_group
    assert model.config.num_negatives == cfg.num_negatives
    want = params_from_jax(_np_tree(pretraining_params_from_hf_model(hf, cfg)))
    sd = model.state_dict()
    assert set(sd) == set(want)
    for name, t in want.items():
        np.testing.assert_array_equal(sd[name].numpy(), t.numpy(), err_msg=name)


@pytest.mark.parametrize("step", [0, 1, 1000, 100000, 300000, 10**7])
def test_gumbel_temperature_matches_jax(step):
    assert cli.gumbel_temperature(cli.PretrainingArgs(), step) == jax_cli.gumbel_temperature(
        jax_cli.PretrainingArgs(), step)


def test_pretraining_args_keep_the_jax_defaults():
    want = dataclasses.asdict(jax_cli.PretrainingArgs())
    ours = dataclasses.asdict(cli.PretrainingArgs())
    assert set(ours) - set(want) == {"device"}
    for name, value in want.items():
        assert ours[name] == value, name


def test_batch_masks_stay_inside_the_real_frames():
    """Spans by the port's `compute_mask_indices`, cut to each row's real
    frames (the JAX CLI's `batch_masks`)."""
    from gsoc_wav2vec2_tpu_torch.ops.specaugment import compute_mask_indices

    cfg = _port_config(tiny_pretraining_config())
    args = cli.PretrainingArgs(mask_time_length=3)
    lengths = np.array([SAMPLES, 4000, 1500, 0])
    am = (np.arange(SAMPLES)[None, :] < lengths[:, None]).astype(np.int32)
    mask = cli.batch_masks(torch.Generator().manual_seed(2), torch.from_numpy(am), cfg, args)
    frames = int(cfg.conv_output_length(SAMPLES))
    assert mask.dtype == torch.bool and mask.shape == (4, frames)
    spans = compute_mask_indices(torch.Generator().manual_seed(2), 4, frames, args.mask_time_prob,
                                 args.mask_time_length)
    for i, n in enumerate(lengths):
        real = max(int(cfg.conv_output_length(int(n))), 0)
        assert not mask[i, real:].any()
        assert torch.equal(mask[i, :real], spans[i, :real])
    assert mask[0].sum() >= 2 and not mask[3].any()
    # numpy masks are taken too
    assert torch.equal(cli.batch_masks(torch.Generator().manual_seed(2), am, cfg, args), mask)
