"""The port's full-state checkpoints, checkpoint averaging and metric log, on
the CPU.

A save / restore round trip of the whole training state (weights, Adam
moments and steps, step count, EMA, the step's generator) that continues
bit for bit; the refusals; `max_to_keep` and the temporary-name write;
`average_checkpoint_params` against the JAX package's function on the same
numbers (a float64 mean), and `cli.average` into a directory the JAX package
loads; a `memory://` checkpoint through fsspec; `MetricLogger`.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_model import port_config_of
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu.models.modeling import init_wav2vec2_for_ctc_params
from gsoc_wav2vec2_tpu.training import checkpoint as jax_checkpoint
from gsoc_wav2vec2_tpu.training.state import TrainState as JaxTrainState
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
    set_learning_rate,
    set_trainable,
)
from gsoc_wav2vec2_tpu_torch.training.checkpoint import (
    CheckpointManager,
    average_checkpoint_params,
)
from gsoc_wav2vec2_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(2)
SAMPLES = 4000
CFG = dict(num_layers=1, filter_sizes=[32, 32], kernal_sizes=[10, 3], strides=[5, 2],
           dropout=0.1, apply_spec_augment=True, mask_time_prob=0.2, mask_time_length=2)


def _model(seed):
    return Wav2Vec2ForCTC(port_config_of(tiny_config(**CFG)), device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _state(seed, frozen=("feature_extractor",), ema=True):
    model = _model(seed)
    set_trainable(model, frozen)
    return create_train_state(model, create_optimizer(model, 1e-3), ema=ema,
                              generator=torch.Generator().manual_seed(100 + seed))


def _batch(seed):
    rng = np.random.default_rng(seed)
    labels = np.zeros((2, 8), np.int32)
    labels[:, :5] = rng.integers(1, 32, size=(2, 5))
    return {"speech": rng.standard_normal((2, SAMPLES)).astype(np.float32), "labels": labels}


def _step(config):
    return make_train_step(config, division_factor=2, ema_decay=0.9)


def _assert_same_state(a, b):
    assert a.step == b.step
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i in sa["state"]:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key]), (i, key)
    for name, t in a.ema_params.items():
        assert torch.equal(t, b.ema_params[name]), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_restored_state_is_the_saved_one_and_continues_bit_for_bit(tmp_path):
    state = _state(seed=0)
    step = _step(state.model.config)
    for i in range(2):
        state, _ = step(state, _batch(i), state.generator)
    set_learning_rate(state.optimizer, 5e-4)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1_000_002, state)
    assert mgr.latest_step() == 1_000_002 and mgr.all_steps() == [1_000_002]
    raw = mgr.restore_raw()
    assert raw["step"] == 2 and raw["learning_rate"] == 5e-4

    fresh = _state(seed=1)
    assert not torch.equal(next(fresh.model.parameters()), next(state.model.parameters()))
    restored = mgr.restore(fresh)
    assert restored is fresh
    _assert_same_state(state, restored)
    # the next update, from the saved and from the restored state, is the same
    state, m1 = step(state, _batch(5), state.generator)
    restored, m2 = step(restored, _batch(5), restored.generator)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(state, restored)


def test_restore_refuses_another_trainable_set_and_missing_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(seed=0))
    mgr.save(1, _state(seed=0))
    with pytest.raises(ValueError, match="other trainable parameters"):
        mgr.restore(_state(seed=0, frozen=("wav2vec2",)))
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(_state(seed=0, ema=False))


def test_max_to_keep_and_the_temporary_name(tmp_path):
    root = tmp_path / "ckpt"
    mgr = CheckpointManager(str(root), max_to_keep=2)
    state = _state(seed=0, ema=False)
    for key in (3, 1_000_000, 7, 2_000_000):
        state.step = key
        mgr.save(key, state)
    assert mgr.all_steps() == [1_000_000, 2_000_000]
    assert sorted(os.listdir(root)) == ["1000000", "2000000"]
    # what a crash leaves (a temporary directory, a step without its file)
    # is no checkpoint
    (root / ".tmp-3000000-1").mkdir()
    (root / "3000000").mkdir()
    assert mgr.latest_step() == 2_000_000
    state.step = 5
    mgr.save(2_000_000, state)  # the same key again replaces it
    assert mgr.restore_raw(2_000_000)["step"] == 5


@pytest.fixture(scope="module")
def averaged(tmp_path_factory):
    """The same three weight sets (p, 2p, 4p of a random p) as JAX Orbax
    checkpoints and as port checkpoints."""
    tmp = tmp_path_factory.mktemp("avg")
    cfg = tiny_config(**CFG)
    base = init_wav2vec2_for_ctc_params(jax.random.PRNGKey(0), cfg)
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    jmgr = jax_checkpoint.CheckpointManager(jax_dir)
    pmgr = CheckpointManager(port_dir)
    state = _state(seed=0, ema=False)
    for step, scale in ((10, 1.0), (20, 2.0), (30, 4.0)):
        params = jax.tree_util.tree_map(lambda x: x * scale + 0.1, base)
        jmgr.save(step, JaxTrainState(step=jax.numpy.asarray(step), params=params,
                                      opt_state=optax.adam(1e-3).init(params)), wait=True)
        state.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        pmgr.save(step, state)
    jmgr.close()
    return cfg, jax_dir, port_dir


@pytest.mark.parametrize("which", [dict(), dict(last_n=2), dict(steps=[10, 30])],
                         ids=["all", "last_n", "steps"])
def test_average_equals_the_jax_function(averaged, which):
    _, jax_dir, port_dir = averaged
    want, want_used = jax_checkpoint.average_checkpoint_params(jax_dir, **which)
    got, used = average_checkpoint_params(port_dir, **which)
    assert used == want_used
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype == torch.float32
        assert torch.equal(got[name], t), name


def test_average_refusals(averaged, tmp_path):
    _, _, port_dir = averaged
    with pytest.raises(ValueError, match="not in checkpoint dir"):
        average_checkpoint_params(port_dir, steps=[10, 99])
    with pytest.raises(ValueError, match="positive"):
        average_checkpoint_params(port_dir, last_n=0)
    with pytest.raises(FileNotFoundError):
        average_checkpoint_params(str(tmp_path / "empty"))


def test_average_cli_writes_a_directory_the_jax_package_loads(averaged, tmp_path, capsys):
    from gsoc_wav2vec2_tpu_torch.cli import average

    cfg, jax_dir, port_dir = averaged
    config_dir = tmp_path / "cfg"
    port_config_of(cfg).save_pretrained(str(config_dir))
    out = str(tmp_path / "averaged")
    average.main(["--ckpt_dir", port_dir, "--config", str(config_dir), "--last_n", "2",
                  "--out", out])
    assert "steps [20, 30]" in capsys.readouterr().out
    want, _ = jax_checkpoint.average_checkpoint_params(jax_dir, last_n=2)
    jax_model = JaxWav2Vec2ForCTC.from_pretrained(out)
    for a, b in zip(jax.tree_util.tree_leaves(jax_model.params), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model = Wav2Vec2ForCTC.from_pretrained(out, device="cpu")
    with torch.no_grad():
        logits = model(torch.zeros(1, SAMPLES))
    assert logits.shape[-1] == cfg.vocab_size and torch.isfinite(logits).all()


def test_remote_checkpoints_through_fsspec():
    import fsspec

    url = "memory://ckpt-test/stage1"
    try:
        state = _state(seed=0)
        mgr = CheckpointManager(url, max_to_keep=1)
        mgr.save(1, state)
        mgr.save(2, state)
        assert mgr.all_steps() == [2]
        _assert_same_state(state, mgr.restore(_state(seed=3)))
    finally:
        fsspec.filesystem("memory").rm("/ckpt-test", recursive=True)


def test_metric_logger_writes_jsonl_and_refuses_a_missing_wandb(tmp_path):
    logger = MetricLogger(str(tmp_path / "logs"))
    logger.log({"stage1/loss": 1.5}, step=3)
    logger.log({"epoch": 0})
    logger.finish()
    lines = [json.loads(l) for l in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [l.get("step") for l in lines] == [3, None]
    assert lines[0]["stage1/loss"] == 1.5 and "ts" in lines[0]
    assert len(MetricLogger(str(tmp_path / "a")).run_id) > 10
    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="wandb"):
            MetricLogger(str(tmp_path / "b"), project="p")
