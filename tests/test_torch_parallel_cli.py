"""`cli.train` as two gloo ranks on the CPU (the tensor-parallel layout
`--model_axis 2` and the data-parallel one): a resumed run is the straight
run bit for bit, a checkpoint written under (1, 2) holds whole tensors and
resumes in one process, and a SIGTERM sent to one rank alone stops both at
the next sync point with one checkpoint.  The ranks are
`tests/torch_parallel_ranks.py::cli_train`; the model is the port's, a
2-layer conv stack, dropout 0.1 and SpecAugment on (so a resume depends on
the checkpointed generator), `--compute_dtype float32`.
"""

import os

import numpy as np
import pytest
import torch

from flac_encoder import encode_flac
from tests import torch_parallel_ranks as R

from gsoc_wav2vec2_tpu_torch.cli import evaluate, train
from gsoc_wav2vec2_tpu_torch.data import native_io
from gsoc_wav2vec2_tpu_torch.models.config import Wav2Vec2Config
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(2)
TEXTS = ["HELLO WORLD", "TINY MODEL", "TPU TRAINING", "FOUR SAMPLES"]
TINY = dict(hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32, 32], kernal_sizes=[10, 3], strides=[5, 2])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(11)
    chap = root / "1" / "1"
    chap.mkdir(parents=True)
    lines = []
    for i, text in enumerate(TEXTS):
        sig = np.clip(2000 * np.sin(np.arange(3000) / 6.0) + rng.normal(0, 60, 3000),
                      -32768, 32767).astype(np.int64)
        (chap / f"1-1-{i:04d}.flac").write_bytes(
            encode_flac(sig, subframe_kind="fixed", order=2, rice_param=7))
        lines.append(f"1-1-{i:04d} {text}")
    (chap / "1-1.trans.txt").write_text("\n".join(lines))
    return str(root)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("model"))
    Wav2Vec2ForCTC(Wav2Vec2Config(**TINY), device="cpu",
                   generator=torch.Generator().manual_seed(0)).save_pretrained(d)
    return d


def _argv(model_dir, corpus, tmp_path, tag, model_axis=1, **kw):
    # a global batch of 2 either way: per device x ranks / model axis
    flags = dict(model_id=model_dir, train_dir=corpus, stage1_epochs=0, stage2_epochs=2,
                 transition_epoch=0, batch_size_per_device=model_axis, audio_maxlen=3000,
                 labels_maxlen=32, compute_dtype="float32", device="cpu",
                 ckpt_dir=str(tmp_path / f"ckpts_{tag}"), log_dir=str(tmp_path / f"logs_{tag}"),
                 model_axis=model_axis, logging_steps=1)
    flags.update(kw)
    return [f"--{k}={v}" for k, v in flags.items()]


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("model_axis", [1, 2], ids=["data2", "model2"])
def test_two_rank_resume_is_the_straight_run_bit_for_bit(model_dir, corpus, tmp_path,
                                                        model_axis):
    """Two stage-2 epochs straight, against one epoch and then `--resume`."""
    straight, cut = R.run_groups([
        ("cli_train", 2, dict(argv=_argv(model_dir, corpus, tmp_path, "straight", model_axis)),
         tmp_path / "s"),
        ("cli_train", 2, dict(argv=_argv(model_dir, corpus, tmp_path, "cut", model_axis,
                                         stage2_epochs=1)), tmp_path / "c")])
    run_dir = cut[0]["run_dir"]
    assert cut[1]["run_dir"] == run_dir  # rank 0's run id
    resumed = R.run_ranks("cli_train", 2, dict(
        argv=_argv(model_dir, corpus, tmp_path, "resumed", model_axis, resume=run_dir)),
        tmp_path / "r")
    assert _equal(straight[0]["final"], resumed[0]["final"])
    assert _equal(resumed[0]["final"], resumed[1]["final"])
    assert not _equal(straight[0]["final"], cut[0]["final"])  # the second epoch moved it


def test_checkpoint_of_a_model_axis_run_resumes_in_one_process(model_dir, corpus, tmp_path,
                                                               capsys):
    """(1, 2) writes whole tensors: the checkpoint's weights and Adam moments
    have the one-process shapes, and one process resumes from it."""
    cut = R.run_ranks("cli_train", 2, dict(
        argv=_argv(model_dir, corpus, tmp_path, "cut", 2, stage2_epochs=1)), tmp_path / "c")
    run_dir = cut[0]["run_dir"]
    raw = CheckpointManager(os.path.join(run_dir, "stage2")).restore_raw()
    whole = Wav2Vec2ForCTC(Wav2Vec2Config(**TINY), device="cpu").state_dict()
    assert {k: v.shape for k, v in raw["model"].items()} == {k: v.shape for k, v in whole.items()}
    shapes = {raw["trainable"][i]: s["exp_avg"].shape for i, s in raw["optimizer"]["state"].items()}
    assert shapes and all(shapes[n] == whole[n].shape for n in shapes)
    torch.testing.assert_close(raw["model"]["wav2vec2.encoder.layers.0.attention.q_proj.kernel"],
                               cut[0]["final"]["wav2vec2.encoder.layers.0.attention.q_proj.kernel"],
                               rtol=0, atol=0)
    train.main(train.parse_args(_argv(model_dir, corpus, tmp_path, "one", resume=run_dir,
                                      batch_size_per_device=2)))
    assert "stage 2: resumed epoch 1" in capsys.readouterr().out
    final = Wav2Vec2ForCTC.from_pretrained(os.path.join(run_dir, "final"), device="cpu")
    assert all(torch.isfinite(t).all() for t in final.state_dict().values())


def test_sigterm_to_one_rank_stops_both_at_the_next_sync_point(model_dir, corpus, tmp_path):
    """Rank 1 alone is signalled after its first update; with
    `--preempt_sync_updates 2` both ranks stop after update 2 (the flag is
    all-gathered there), with one checkpoint at key 2 (epoch 0, update 2)
    and no `final/`."""
    outs = R.run_ranks("cli_train", 2, dict(
        argv=_argv(model_dir, corpus, tmp_path, "term", stage2_epochs=4,
                   preempt_sync_updates=2),
        sigterm_rank=1, sigterm_after=1), tmp_path / "t")
    run_dir = outs[0]["run_dir"]
    assert outs[0]["final"] is None and outs[1]["final"] is None
    assert CheckpointManager(os.path.join(run_dir, "stage2")).all_steps() == [2]


def test_sharded_evaluate_cli_counts_each_record_once(model_dir, tmp_path):
    """`cli.evaluate --sharded` as two ranks on one TFRecord shard of 5
    utterances: each rank decodes its records (every other one: 3 and 2, so
    rank 1 runs one batch of 2 and then a dummy batch while rank 0 runs its
    second), and the aggregated report is one process's: the same WER over 5
    samples, not 10 (F7: the JAX CLI reads every record on every process)."""
    rng = np.random.default_rng(3)
    shard = str(tmp_path / "eval.tfrecord")
    with native_io.TFRecordWriter(shard) as w:
        for i in range(5):
            audio = rng.standard_normal(2000 + 150 * i).astype(np.float32)
            w.write(audio, rng.integers(1, 30, size=4).astype(np.int32))
    argv = ["--model_dir", model_dir, "--tfrecords", shard, "--mode", "padded",
            "--pad_to", "3000", "--batch_size", "2", "--device", "cpu"]
    want = evaluate.main(argv)
    outs = R.run_ranks("cli_evaluate", 2, dict(argv=argv + ["--sharded"]),
                       tmp_path / "e")
    assert want["num_samples"] == 5
    for report in outs:
        assert (report["wer"], report["num_samples"]) == (want["wer"], 5)


def test_two_rank_pretrain_cli_runs_in_lockstep_and_exports_once(corpus, tmp_path):
    """`cli.pretrain` as two ranks (data 2 and model 2): the global batch is
    2 utterances a step, so the 4-utterance corpus gives 2 updates an epoch
    either way; rank 0 alone logs (its metrics file holds every update) and
    writes `for_ctc/` from whole tensors, which loads as the one-process
    model does."""
    from gsoc_wav2vec2_tpu_torch.models.pretraining import Wav2Vec2PretrainingConfig

    cfg_dir = tmp_path / "cfg"
    Wav2Vec2PretrainingConfig(**TINY, num_codevector_groups=2, num_codevectors_per_group=16,
                              codevector_dim=48, proj_codevector_dim=40,
                              num_negatives=10).save_pretrained(str(cfg_dir))
    runs = []
    for model_axis in (1, 2):
        flags = dict(config=str(cfg_dir / "config.json"), train_dir=corpus, epochs=1,
                     batch_size_per_device=1 if model_axis == 1 else 2, audio_maxlen=3000,
                     mask_time_length=2, warmup_steps=1, logging_steps=1, device="cpu",
                     compute_dtype="float32", model_axis=model_axis,
                     ckpt_dir=str(tmp_path / f"ckpt{model_axis}"),
                     log_dir=str(tmp_path / f"logs{model_axis}"))
        runs.append(("cli_pretrain", 2, dict(argv=[f"--{k}={v}" for k, v in flags.items()]),
                     tmp_path / f"r{model_axis}"))
    for (rank0, rank1), model_axis in zip(R.run_groups(runs), (1, 2)):
        assert rank0["exported"] and rank1["exported"]  # one shared directory
        steps = [m["step"] for m in rank0["logged"] if "pretrain/loss" in m]
        assert steps == [1, 2], steps
        assert all(np.isfinite(m["pretrain/loss"]) for m in rank0["logged"] if "pretrain/loss" in m)
        model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path / f"ckpt{model_axis}" / "for_ctc"),
                                               device="cpu")
        kernel = model.state_dict()["wav2vec2.encoder.layers.0.attention.q_proj.kernel"]
        assert kernel.shape == (64, 64) and torch.isfinite(kernel).all()



def test_model_axis_that_does_not_divide_the_heads_raises_jax_message(model_dir, corpus,
                                                                      tmp_path):
    """JAX's check and message (`gsoc_wav2vec2_tpu/cli/train.py:599-606`),
    raised before any mesh is built."""
    with pytest.raises(ValueError, match=r"^--model_axis 3 must divide num_heads \(4\) and "
                                         r"intermediate_size \(128\) for tensor-parallel sharding$"):
        train.main(train.parse_args(_argv(model_dir, corpus, tmp_path, "axis3", model_axis=3)))


def test_global_batch_the_processes_do_not_divide_raises_jax_message(model_dir, corpus,
                                                                     tmp_path):
    """Two ranks with `--model_axis 2` and one row a device: a global batch of
    1, which JAX refuses with this message (`gsoc_wav2vec2_tpu/cli/train.py:214-219`)."""
    outs = R.run_ranks("cli_train_error", 2, dict(
        argv=_argv(model_dir, corpus, tmp_path, "odd", model_axis=2, batch_size_per_device=1)),
        tmp_path / "o")
    assert [o["error"] for o in outs] == ["global batch 1 not divisible by 2 processes"] * 2
