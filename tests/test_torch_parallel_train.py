"""Data and tensor parallelism over several processes, against one process.

Each run is 2 or 4 gloo ranks on the CPU at one thread
(`tests/torch_parallel_ranks.py`), the tiny config in f32; the reference is
the same program in this process on the global batch.  Hidden dropout and
SpecAugment are on (each rank takes its block of the one-process draws);
attention dropout is off, since its seeds are shard-dependent as in JAX's
mesh run (held against JAX's `shard_map` in `test_torch_parallel.py`).

With attention dropout, whose seeds are shard-dependent, the sharded step
is held against JAX's sharded step instead: JAX's `make_train_step(mesh=...)`
through `shard_mapped_flash_attention` (the Pallas kernel in interpret mode)
on a 2-device CPU mesh, both sides with attention dropout alone and one
attention seed before the shard offset.

Tolerance `rtol = atol = 1e-5` (f32, sums in another order).  One parameter
is held otherwise: `k_proj.bias`, whose gradient is 0 in exact arithmetic (a
key bias adds the same q . b to every score of a query row, which the
softmax cancels), so its rounding noise drives Adam's sign-normalised
updates: within 2 x lr a step of the one-process value, as in any two
orders of summation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.ops.pallas import flash_attention as jax_fa
from gsoc_wav2vec2_tpu.parallel import make_mesh as jax_make_mesh
from gsoc_wav2vec2_tpu.parallel import shard_params as jax_shard_params
from gsoc_wav2vec2_tpu.training import state as jax_state
from gsoc_wav2vec2_tpu.training import trainer as jax_trainer
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_to_jax
from gsoc_wav2vec2_tpu_torch.models import modeling

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _assert_params(got: dict, want: dict, steps: int, lr: float = 1e-3):
    assert got.keys() == want.keys()
    for name in want:
        if name.endswith("k_proj.bias"):
            assert (got[name] - want[name]).abs().max() <= 2 * steps * lr, name
        else:
            torch.testing.assert_close(got[name], want[name], **TOL, msg=name)


def _assert_ranks_agree(outs, keys=("loss", "grad_norm")):
    for o in outs[1:]:
        for k in keys:
            assert o[k] == outs[0][k], k


@pytest.mark.parametrize("accum", [1, 2])
def test_data_parallel_fine_tune_equals_one_process(tmp_path, accum):
    """(2, 1): two updates (of two microbatches each with `accum` 2) with
    hidden dropout and SpecAugment: the losses, gradient norms and the
    parameters after them."""
    want = R.ctc_train([1, 1], accum=accum)
    outs = R.run_ranks("ctc_train", 2, dict(mesh=[2, 1], accum=accum), tmp_path)
    _assert_ranks_agree(outs)
    np.testing.assert_allclose(outs[0]["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(outs[0]["grad_norm"], want["grad_norm"], **TOL)
    for o in outs:
        _assert_params(o["params"], want["params"], steps=2)


def test_data_parallel_masked_robust_fine_tune_equals_one_process(tmp_path):
    """The robust family with ragged sample masks and length-aware CTC."""
    kw = dict(robust=True, masked=True)
    want = R.ctc_train([1, 1], **kw)
    outs = R.run_ranks("ctc_train", 2, dict(mesh=[2, 1], **kw), tmp_path)
    np.testing.assert_allclose(outs[0]["loss"], want["loss"], **TOL)
    _assert_params(outs[1]["params"], want["params"], steps=2)


@pytest.mark.parametrize("mesh", [[1, 2], [2, 2], [2, 1]], ids=["1x2", "2x2", "2x1"])
def test_tensor_parallel_logits_loss_and_grads_equal_one_process(tmp_path, mesh):
    """A forward and backward with hidden dropout and SpecAugment: each
    rank's logits rows, the global loss and gradient norm, and the gradients
    summed over the data group and gathered over the model group; the gather
    of the shards is the whole model."""
    want = R.ctc_train([1, 1], grads_only=True)
    outs = R.run_ranks("ctc_train", mesh[0] * mesh[1], dict(mesh=mesh, grads_only=True), tmp_path)
    _assert_ranks_agree(outs)
    assert all(o["roundtrip"] for o in outs)
    np.testing.assert_allclose(outs[0]["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(outs[0]["grad_norm"], want["grad_norm"], **TOL)
    covered = set()
    for o in outs:
        r0, r1 = o["rows"]
        covered.update(range(r0, r1))
        torch.testing.assert_close(o["logits"], want["logits"][r0:r1], **TOL)
        assert o["grads"].keys() == want["grads"].keys()
        for name, g in want["grads"].items():
            torch.testing.assert_close(o["grads"][name], g, **TOL, msg=name)
    assert covered == set(range(4))


def _jax_mesh(mesh_shape, **config):
    """JAX's tiny config, `ctc_train`'s starting weights sharded on a
    `mesh_shape` CPU mesh, the mesh and the stage-2 frozen names."""
    model = modeling.Wav2Vec2ForCTC(R.port_config(), device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    R._nonzero_biases(model, 0)  # as `ctc_train` starts
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    data, axis = mesh_shape
    mesh = jax_make_mesh(data=data, model=axis, devices=jax.devices()[:data * axis])
    return tiny_config(**config), params, mesh, ("feature_extractor",)


# with attention dropout, the flash path: its sharded call is what the port mirrors
def _impl(config) -> str:
    return "flash" if config.get("dropout") else "xla"


def _jax_mesh_step(mesh_shape, steps: int, **config):
    """JAX's `make_train_step` on a `mesh_shape` CPU mesh (f32, remat off):
    each update's loss and gradient norm."""
    cfg, params, mesh, frozen = _jax_mesh(mesh_shape, **config)
    tx = jax_state.create_optimizer(1e-3, jax_state.trainable_mask(params, frozen))
    params = jax_shard_params(params, mesh)
    state = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=tx.init(params))
    step = jax_trainer.make_train_step(cfg, tx, division_factor=4, compute_dtype=jnp.float32,
                                       remat=False, mesh=mesh, attention_impl=_impl(config),
                                       frozen=frozen)
    out = {"loss": [], "grad_norm": []}
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in R._ctc_batch(4, 2 + i, False).items()}
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    return out


def _jax_mesh_grads(mesh_shape, **config):
    """The loss and gradients of JAX's training loss (`_make_ctc_loss_fn`,
    what its step differentiates) on a `mesh_shape` CPU mesh, for
    `ctc_train(grads_only=True)`'s batch: loss, gradient norm and the
    gradients by port name."""
    from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax

    cfg, params, mesh, frozen = _jax_mesh(mesh_shape, **config)
    loss_fn = jax_trainer._make_ctc_loss_fn(
        cfg, division_factor=4, with_attention_mask=False, length_aware=False,
        compute_dtype=jnp.float32, remat=False, mesh=mesh, attention_impl=_impl(config),
        frozen=frozen)
    batch = {k: jnp.asarray(v) for k, v in R._ctc_batch(4, 2, False).items()}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax_shard_params(params, mesh), batch,
                                                       jax.random.PRNGKey(0))
    return {"loss": float(loss), "grad_norm": float(jax_trainer.global_norm(grads)),
            "grads": params_from_jax(jax.device_get(grads))}


def test_port_2x2_loss_equals_jax_mesh_step(tmp_path):
    """JAX's `make_train_step(mesh=make_mesh(2, 2), attention_impl="xla",
    compute_dtype=float32)` from the same weights, dropout 0: the loss of
    each of three updates (the third after two updates) at rtol 1e-5."""
    kw = dict(dropout=0.0, spec_augment=False, steps=3)
    outs = R.run_ranks("ctc_train", 4, dict(mesh=[2, 2], **kw), tmp_path)
    np.testing.assert_allclose(outs[0]["loss"], _jax_mesh_step((2, 2), 3)["loss"], rtol=1e-5)


ATTENTION_SEED = 4321


@pytest.mark.parametrize("mesh", [[2, 1], [1, 2]], ids=["2x1", "1x2"])
def test_attention_dropout_step_equals_jax_sharded_step(tmp_path, monkeypatch, mesh):
    """Attention dropout 0.1 on two ranks equals JAX's sharded step on a
    2-device mesh (each shard's flash seed `seed + shard * 2**20`, the hash
    over the shard's local rows and heads): the loss, gradient norm and
    every gradient of one forward and backward, then the losses and
    gradient norms of two updates.  The port's one-process step, whose one
    shard keeps `seed` everywhere, differs."""
    kw = dict(dropout=0.1, spec_augment=False, attention_seed=ATTENTION_SEED)
    grads, steps = R.run_groups([
        ("ctc_train", 2, dict(mesh=mesh, grads_only=True, **kw), tmp_path / "g"),
        ("ctc_train", 2, dict(mesh=mesh, **kw), tmp_path / "s")])
    one = R.ctc_train([1, 1], grads_only=True, **kw)

    flash, sharded = jax_fa.flash_attention, jax_fa.shard_mapped_flash_attention
    monkeypatch.setattr(jax_modeling, "dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(jax_fa, "flash_attention",
                        lambda *a, **k: flash(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jax_fa, "shard_mapped_flash_attention",
                        lambda *a, **k: sharded(*a, **{**k, "dropout_seed": ATTENTION_SEED}))
    want = _jax_mesh_grads(tuple(mesh), dropout=0.1)
    _assert_ranks_agree(grads)
    for o in grads:
        np.testing.assert_allclose(o["loss"], want["loss"], **TOL)
        np.testing.assert_allclose(o["grad_norm"], want["grad_norm"], **TOL)
        assert o["grads"].keys() <= want["grads"].keys()
        for name, g in o["grads"].items():
            torch.testing.assert_close(g, want["grads"][name], **TOL, msg=name)
    assert abs(one["loss"] - want["loss"]) > 1e-3 * abs(want["loss"])
    stepped = _jax_mesh_step(tuple(mesh), 2, dropout=0.1)
    _assert_ranks_agree(steps)
    np.testing.assert_allclose(steps[0]["loss"], stepped["loss"], **TOL)
    np.testing.assert_allclose(steps[0]["grad_norm"], stepped["grad_norm"], **TOL)


@pytest.mark.parametrize("mesh", [[2, 1], [1, 2]], ids=["2x1", "1x2"])
def test_gather_loss_pretraining_equals_one_process(tmp_path, mesh):
    """Two pretraining updates with the `gather` loss (the negatives' backward
    through `scatter_rows_add`'s plain version, per rank on its rows): the
    loss, its parts, the perplexity (a marginal over the global batch's
    masked frames) and the parameters.  A diversity term counted once per
    rank instead of once would move the loss and every gradient."""
    want = R.pretrain_train([1, 1])
    outs = R.run_ranks("pretrain_train", 2, dict(mesh=mesh), tmp_path)
    for o in outs:
        for got, ref in zip(o["metrics"], want["metrics"]):
            assert got.keys() == ref.keys()
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)
        _assert_params(o["params"], want["params"], steps=2)
