"""The port's fine-tuning and evaluation CLIs end to end, on the CPU.

Ports of `tests/test_train_cli.py` (end to end with gradient accumulation,
the profiler and a test loss; bit-exact `--resume`; bit-exact SIGTERM
preemption; the refusal of epochs with no update), of the bucketed CLI run
of `tests/test_bucketed_training.py`, and of the WER-0 gate of
`tests/test_wer_gate.py` (greedy), all through `cli.train` and
`cli.evaluate` in process, with the tiny models saved by the JAX package's
`save_pretrained`: hidden 64, 4 heads, f32 (`--compute_dtype float32`).
`cli.evaluate`'s three modes are held against the JAX evaluator.
"""

import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_encoder import encode_flac

from gsoc_wav2vec2_tpu import Wav2Vec2Config
from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu_torch.cli import evaluate, train
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(2)
TEXTS = ["HELLO WORLD", "TINY MODEL", "TPU TRAINING", "FOUR SAMPLES"]
TINY = dict(hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32, 32], kernal_sizes=[10, 3], strides=[5, 2])


def _corpus(root, audio_len, carrier, seed=11, lengths=None, texts=TEXTS):
    rng = np.random.default_rng(seed)
    chap = root / "1" / "1"
    chap.mkdir(parents=True)
    lines = []
    for i, text in enumerate(texts):
        n = audio_len if lengths is None else lengths[i]
        sig = np.clip(2000 * np.sin(np.arange(n) / carrier(i)) + rng.normal(0, 60, n),
                      -32768, 32767).astype(np.int64)
        (chap / f"1-1-{i:04d}.flac").write_bytes(
            encode_flac(sig, subframe_kind="fixed", order=2, rice_param=7))
        lines.append(f"1-1-{i:04d} {text}")
    (chap / "1-1.trans.txt").write_text("\n".join(lines))
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("corpus"), 6000, lambda i: 6.0)


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    """The recipe's regularisation (dropout 0.1, SpecAugment), so that the
    resumed runs depend on the checkpointed generator."""
    d = str(tmp_path_factory.mktemp("tiny_model"))
    JaxWav2Vec2ForCTC(Wav2Vec2Config(**TINY), seed=0).save_pretrained(d)
    return d


def _args(model_dir, data_dir, tmp_path, tag, **kw):
    base = dict(model_id=model_dir, train_dir=data_dir, stage1_epochs=1, stage2_epochs=1,
                batch_size_per_device=1, audio_maxlen=6000, labels_maxlen=32,
                compute_dtype="float32", device="cpu", ckpt_dir=str(tmp_path / f"ckpts_{tag}"),
                log_dir=str(tmp_path / f"logs_{tag}"))
    base.update(kw)
    return train.TrainingArgs(**base)


def _run(args):
    train.main(args)
    return args.ckpt_dir  # main points it at the run directory


def _final(run_dir, name="final"):
    return Wav2Vec2ForCTC.from_pretrained(os.path.join(run_dir, name), device="cpu")


def _assert_same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa and sa.keys() == sb.keys()
    for name, t in sa.items():
        assert torch.equal(t, sb[name]), name


def test_train_cli_end_to_end(corpus, tiny_model_dir, tmp_path, capsys):
    args = _args(tiny_model_dir, corpus, tmp_path, "e2e", test_dir=corpus,
                 # 2 x 2 accumulated microbatches: one update of 4 samples an epoch
                 batch_size_per_device=2, grad_accum=2, logging_steps=1, profile_steps=1,
                 ema_decay=0.5)
    run_dir = _run(args)
    out = capsys.readouterr().out
    assert "test loss:" in out
    assert "profiler trace written" in out
    traces = os.listdir(os.path.join(args.log_dir, "trace"))
    assert sorted(traces) == ["stage1.json", "stage2.json"]
    json.load(open(os.path.join(args.log_dir, "trace", "stage2.json")))

    metrics = [json.loads(l) for l in open(os.path.join(args.log_dir, "metrics.jsonl"))]
    keys = {k for m in metrics for k in m}
    assert {"stage1/loss", "stage2/loss", "test_loss", "stage2/data_wait_s"} <= keys
    assert all(np.isfinite(m["stage1/loss"]) for m in metrics if "stage1/loss" in m)
    assert [m["stage2/batches"] for m in metrics if "stage2/batches" in m] == [2]

    assert os.path.dirname(run_dir) == str(tmp_path / "ckpts_e2e")
    assert sorted(os.listdir(run_dir)) == ["final", "final_ema", "stage1", "stage2"]
    assert CheckpointManager(os.path.join(run_dir, "stage2")).all_steps() == [1_000_000]
    for name in ("final", "final_ema"):
        reloaded = _final(run_dir, name)
        with torch.no_grad():
            logits = reloaded(torch.zeros(1, 6000))
        assert logits.shape[0] == 1 and logits.shape[2] == reloaded.config.vocab_size
        # and the JAX package reads what the port wrote
        jax_model = JaxWav2Vec2ForCTC.from_pretrained(os.path.join(run_dir, name))
        assert np.asarray(jax_model(np.zeros((1, 6000), np.float32))).shape == tuple(logits.shape)


def test_train_cli_resume_bit_exact(corpus, tiny_model_dir, tmp_path, capsys):
    """1 stage-1 epoch, then `--resume` to 2 + 1 stage-2 epoch, equals the
    straight run bit for bit (weights, Adam moments, the step's generator)."""
    common = dict(stage1_epochs=2, stage2_epochs=1, transition_epoch=0, batch_size_per_device=4)
    straight = _run(_args(tiny_model_dir, corpus, tmp_path, "straight", **common))
    resumed = _run(_args(tiny_model_dir, corpus, tmp_path, "resumed",
                         **dict(common, stage1_epochs=1, stage2_epochs=0)))
    capsys.readouterr()
    _run(_args(tiny_model_dir, corpus, tmp_path, "resumed2", **common, resume=resumed))
    assert "stage 1: resumed epoch 1" in capsys.readouterr().out
    _assert_same_weights(_final(straight), _final(resumed))


def test_train_cli_sigterm_preemption_bit_exact(corpus, tiny_model_dir, tmp_path, capsys,
                                                 monkeypatch):
    """SIGTERM after the third update (mid-epoch: two updates an epoch) saves
    a step-granular checkpoint and stops; `--resume` skips the updates it
    holds and ends where the straight run ends, bit for bit."""
    common = dict(stage1_epochs=4, stage2_epochs=0, batch_size_per_device=2, logging_steps=1)
    straight = _run(_args(tiny_model_dir, corpus, tmp_path, "straight", **common))

    real = train.make_train_step

    def make_step(*a, **kw):
        step = real(*a, **kw)
        calls = []

        def counted(state, batch, gen):
            out = step(state, batch, gen)
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return counted

    monkeypatch.setattr(train, "make_train_step", make_step)
    capsys.readouterr()
    preempted = _run(_args(tiny_model_dir, corpus, tmp_path, "preempt", **common))
    out = capsys.readouterr().out
    assert "preempted — saved epoch 1 update 1 (key 1000001)" in out
    assert not os.path.exists(os.path.join(preempted, "final"))
    assert CheckpointManager(os.path.join(preempted, "stage1")).latest_step() == 1_000_001
    assert signal.getsignal(signal.SIGTERM) is not train._on_sigterm  # restored

    monkeypatch.setattr(train, "make_train_step", real)
    _run(_args(tiny_model_dir, corpus, tmp_path, "preempt2", **common, resume=preempted))
    assert "stage 1: resumed epoch 1 (+1 updates)" in capsys.readouterr().out
    _assert_same_weights(_final(straight), _final(preempted))


def test_train_cli_refuses_zero_update_epochs(corpus, tiny_model_dir, tmp_path):
    args = _args(tiny_model_dir, corpus, tmp_path, "zero", stage2_epochs=0,
                 batch_size_per_device=4, grad_accum=2)  # 1 batch an epoch < 2
    with pytest.raises(RuntimeError, match="never completed an optimizer update"):
        train.main(args)


# the first case's id is the one it had while --model_axis > 1 was refused as
# not ported; a model axis the processes cannot fill is refused now
@pytest.mark.parametrize("flags,match", [
    (dict(model_axis=2), "model axis 2 does not divide device count 1"),
    (dict(remat_policy="offload"), "remat_policy"),
    (dict(compute_dtype="float16"), "compute_dtype"), (dict(grad_accum=0), "grad_accum"),
], ids=["flags0-item 7", "flags1-remat_policy", "flags2-compute_dtype", "flags3-grad_accum"])
def test_train_cli_refuses_what_is_not_ported(corpus, tiny_model_dir, tmp_path, flags, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        train.main(_args(tiny_model_dir, corpus, tmp_path, "refuse", **flags))


def test_training_args_keep_the_jax_fields_env_vars_and_flags(monkeypatch, tmp_path):
    import dataclasses

    from gsoc_wav2vec2_tpu.cli import train as jax_train

    ours = {f.name: f for f in dataclasses.fields(train.TrainingArgs)}
    theirs = {f.name: f for f in dataclasses.fields(jax_train.TrainingArgs)}
    assert set(ours) - set(theirs) == {"device"}
    for name, f in theirs.items():
        assert ours[name].default == f.default, name
    assert (train.TrainingArgs().remat, train.TrainingArgs().remat_policy) == (True, "dots")
    monkeypatch.setenv("CKPT_BUCKET_NAME", str(tmp_path / "bucket"))
    monkeypatch.setenv("DATA_BUCKET_NAME", str(tmp_path / "data"))
    args = train.TrainingArgs()
    assert args.ckpt_dir == str(tmp_path / "bucket")
    assert args.train_tfrecords == [str(tmp_path / "data" / "train" / "*.tfrecord")]
    parsed = train.parse_args(["--stage1_epochs", "3", "--bucket_boundaries", "2000", "3200",
                               "--device", "cpu", "--no-remat", "--ema_decay", "0.9"])
    assert (parsed.stage1_epochs, parsed.bucket_boundaries, parsed.device, parsed.ema_decay) == \
        (3, [2000, 3200], "cpu", 0.9)


def test_train_cli_remat_equals_no_remat(corpus, tiny_model_dir, tmp_path):
    """The default `--remat --remat_policy dots`, `--remat_policy full` and
    `--no-remat` train to bit-equal weights (the recipe's dropout and
    SpecAugment: the rematerialised layers redraw nothing)."""
    runs = [_run(_args(tiny_model_dir, corpus, tmp_path, tag, stage1_epochs=0, **kw))
            for tag, kw in (("dots", {}), ("full", dict(remat_policy="full")),
                            ("off", dict(remat=False)))]
    assert train.parse_args(["--remat_policy", "full"]).remat is True
    for run_dir in runs[1:]:
        _assert_same_weights(_final(runs[0]), _final(run_dir))


def test_train_cli_bucketed_end_to_end(tmp_path):
    """Mixed lengths (two past `audio_maxlen`, kept by the 3200 bucket), two
    batch shapes, length-aware loss, the final model saved."""
    model_dir = str(tmp_path / "model")
    JaxWav2Vec2ForCTC(Wav2Vec2Config(**TINY, dropout=0.0, apply_spec_augment=False,
                                     survival_prob=1.0), seed=0).save_pretrained(model_dir)
    data = _corpus(tmp_path / "data", None, lambda i: 3.0 + i, seed=5,
                   lengths=(1500, 1800, 3000, 2900), texts=["SOME WORDS"] * 4)
    args = _args(model_dir, data, tmp_path, "bucketed", batch_size_per_device=2,
                 audio_maxlen=2000, labels_maxlen=16, bucket_boundaries=[2000, 3200],
                 logging_steps=1)
    run_dir = _run(args)
    metrics = [json.loads(l) for l in open(os.path.join(args.log_dir, "metrics.jsonl"))]
    losses = [m["stage2/loss"] for m in metrics if "stage2/loss" in m]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.path.isfile(os.path.join(run_dir, "final", "config.json"))


@pytest.fixture(scope="module")
def wer_corpus(tmp_path_factory):
    """Four utterances, a carrier frequency each (`tests/test_wer_gate.py`)."""
    return _corpus(tmp_path_factory.mktemp("wer_corpus"), 4000, lambda i: 3.0 + 2.0 * i)


def test_two_stage_cli_reaches_wer_zero(wer_corpus, tmp_path, capsys):
    """`tests/test_wer_gate.py` through the port: the tiny model (no
    dropout, no SpecAugment) overfits the four utterances through both
    stages, and `cli.evaluate --mode single --round_to 1` reads them back
    with WER 0."""
    model_dir = str(tmp_path / "model")
    JaxWav2Vec2ForCTC(Wav2Vec2Config(**TINY, dropout=0.0, apply_spec_augment=False,
                                     survival_prob=1.0), seed=0).save_pretrained(model_dir)
    run_dir = _run(_args(model_dir, wer_corpus, tmp_path, "wer", stage1_epochs=5,
                         stage2_epochs=300, stage2_lr1=5e-4, stage2_lr2=5e-4,
                         batch_size_per_device=4, audio_maxlen=4000, logging_steps=50,
                         ckpt_every_epochs=50))
    capsys.readouterr()
    report = evaluate.main(["--model_dir", os.path.join(run_dir, "final"), "--data_dir",
                            wer_corpus, "--mode", "single", "--round_to", "1",
                            "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert report["num_samples"] == len(TEXTS)
    assert report["wer"] == 0.0, report


@pytest.mark.parametrize("mode,extra", [("padded", ["--pad_to", "8000", "--batch_size", "3"]),
                                        ("bucketed", ["--batch_size", "3"]),
                                        ("single", ["--round_to", "1600"])])
def test_evaluate_cli_matches_the_jax_evaluator(corpus, tiny_model_dir, tmp_path, mode, extra,
                                                capsys, monkeypatch):
    """The three modes over tfrecord shards of the corpus against the JAX
    evaluator on the same model directory and samples: each forward's padded
    input and true lengths bit-equal, each utterance's hypothesis the same
    string (the WER of an untrained model saturates at 1), and the WER."""
    from gsoc_wav2vec2_tpu_torch.cli import make_tfrecords
    from gsoc_wav2vec2_tpu_torch.data import native_io
    from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor
    from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator

    calls = {"port": [], "jax": []}

    def record(cls, key):
        predict = cls.predict_batch

        def recorded(self, speech, sample_lengths=None):
            hyps = predict(self, speech, sample_lengths)
            calls[key].append((np.array(speech), np.asarray(sample_lengths), list(hyps)))
            return hyps

        monkeypatch.setattr(cls, "predict_batch", recorded)

    record(GreedyCTCEvaluator, "port")
    record(JaxEvaluator, "jax")
    shards = tmp_path / "shards"
    make_tfrecords.main(["--data_dir", corpus, "-d", str(shards), "-n", "2"])
    tok = Wav2Vec2Processor(is_tokenizer=True)
    samples = [(s, tok.decode(l, group_tokens=False)) for p in sorted(shards.iterdir())
               for s, l in native_io.read_tfrecords(str(p))]
    assert sorted(t for _, t in samples) == sorted(TEXTS)
    jax_model = JaxWav2Vec2ForCTC.from_pretrained(tiny_model_dir)
    jax_ev = JaxEvaluator(jax_model.config, jax_model.params, compute_dtype=jnp.float32)
    if mode == "padded":
        want, n = jax_ev.evaluate_padded(iter(samples), batch_size=3, pad_to=8000)
    elif mode == "bucketed":
        want, n = jax_ev.evaluate_bucketed(iter(samples), batch_size=3)
    else:
        refs, hyps = [], []
        for audio, text in samples:
            padded = np.pad(audio, (0, -(-len(audio) // 1600) * 1600 - len(audio)))
            hyps += jax_ev.predict_batch(padded[None, :], np.asarray([len(audio)]))
            refs.append(text)
        from gsoc_wav2vec2_tpu.utils.metrics import wer

        want, n = wer(refs, hyps), len(refs)
    report = evaluate.main(["--model_dir", tiny_model_dir, "--tfrecords",
                            str(shards / "*.tfrecord"), "--mode", mode, "--device", "cpu",
                            *extra])
    assert report["num_samples"] == n == 4
    assert len(calls["port"]) == len(calls["jax"]) > 0
    for (speech, lengths, hyps), (want_speech, want_lengths, want_hyps) in zip(calls["port"],
                                                                             calls["jax"]):
        np.testing.assert_array_equal(speech, want_speech)
        np.testing.assert_array_equal(lengths, want_lengths)
        assert hyps == want_hyps
    assert sum(len(c[2]) for c in calls["port"]) == 4
    assert any(h for c in calls["port"] for h in c[2])  # not all empty
    assert report["wer"] == round(want, 5)
    assert report["mode"] == mode and ("round_to" in report) == (mode == "single")


def test_evaluate_cli_refuses_beam_search_and_lm(corpus, tiny_model_dir, tmp_path, capsys,
                                                 monkeypatch):
    """Beam search and LM fusion, once refused, now run: `cli.evaluate
    --beam_width 4 --lm_path ...` gives the JAX CLI's hypotheses utterance by
    utterance (the JAX CLI's evaluator held at f32) and its report."""
    import functools
    import sys

    from gsoc_wav2vec2_tpu.cli import evaluate as jax_evaluate
    from gsoc_wav2vec2_tpu.decoding import CharNGramLM
    from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator

    lm_path = str(tmp_path / "lm.json")
    CharNGramLM.fit_from_librispeech(corpus, order=3).save(lm_path)
    hyps = {"port": [], "jax": []}
    for cls, key in ((GreedyCTCEvaluator, "port"), (JaxEvaluator, "jax")):
        predict = cls.predict_batch

        def recorded(self, speech, sample_lengths=None, _predict=predict, _key=key):
            out = _predict(self, speech, sample_lengths)
            hyps[_key].extend(out)
            return out

        monkeypatch.setattr(cls, "predict_batch", recorded)
    monkeypatch.setattr(jax_evaluate, "GreedyCTCEvaluator",
                        functools.partial(JaxEvaluator, compute_dtype=jnp.float32))
    argv = ["--model_dir", tiny_model_dir, "--data_dir", corpus, "--mode", "padded",
            "--pad_to", "6000", "--batch_size", "3", "--beam_width", "4", "--lm_path", lm_path,
            "--lm_weight", "0.3"]
    report = evaluate.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["evaluate", *argv])
    jax_evaluate.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(hyps["port"]) == len(TEXTS) and hyps["port"] == hyps["jax"]
    assert any(hyps["port"])
    report.pop("seconds"), want.pop("seconds")
    assert report == want and report["beam_width"] == 4 and report["lm"]["weight"] == 0.3
