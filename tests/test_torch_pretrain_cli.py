"""The port's pretraining CLI (`cli/pretrain.py`) end to end on the CPU, and
the pretraining forward and loss against the HF oracle.

Ports of `tests/test_pretraining.py:209-445` (the end-to-end run with EMA,
accumulation and both exports; TFRecords and the resume refusal; SIGTERM
then `--resume`), run in process with `--device cpu` and f32, plus a resumed
run held bit for bit against the straight one.  And of
`tests/test_pretraining.py:42-136`: `transformers.Wav2Vec2ForPreTraining`
built from a config (nothing downloaded), its weights loaded into the port
through `convert/hf_torch.py`, eval forward and loss against it for the base
and robust families at the JAX test's tolerances (projected states 2e-4,
quantized 2e-5, perplexity 1e-5, loss parts 2e-4 / diversity 1e-4).
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from flac_encoder import encode_flac

from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.cli import pretrain
from gsoc_wav2vec2_tpu_torch.convert.hf_torch import state_dict_from_hf
from gsoc_wav2vec2_tpu_torch.data.native_io import TFRecordWriter
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import pretraining as pt
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.training.checkpoint import CheckpointManager
from tests.utils import matching_hf_config, requires_transformers, tiny_pretraining_config

torch.set_num_threads(2)
SAMPLES = 6000


def _port_config(cfg):
    cls = (port_config.RobustWav2Vec2PretrainingConfig if cfg.is_robust
           else port_config.Wav2Vec2PretrainingConfig)
    return cls(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 FLAC utterances of 6000 samples (transcripts unused)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(3)
    chap = root / "1" / "1"
    chap.mkdir(parents=True)
    lines = []
    for i in range(8):
        sig = np.clip(2000 * np.sin(np.arange(SAMPLES) / (5.0 + i)) + rng.integers(-60, 60, SAMPLES),
                      -32768, 32767).astype(np.int64)
        (chap / f"1-1-{i:04d}.flac").write_bytes(
            encode_flac(sig, subframe_kind="fixed", order=2, rice_param=7))
        lines.append(f"1-1-{i:04d} UNUSED TEXT")
    (chap / "1-1.trans.txt").write_text("\n".join(lines))
    return str(root)


@pytest.fixture(scope="module")
def config_json(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    # the recipe's regularisation, so that a resume depends on the checkpointed generator
    _port_config(tiny_pretraining_config(num_layers=1, dropout=0.1)).save_pretrained(str(d))
    return str(d / "config.json")


def _args(config_json, tmp_path, tag, **kw):
    base = dict(config=config_json, epochs=2, batch_size_per_device=2, audio_maxlen=SAMPLES,
                mask_time_length=2, warmup_steps=4, lr=1e-4, logging_steps=1,
                compute_dtype="float32", device="cpu", ckpt_dir=str(tmp_path / f"ckpts_{tag}"),
                log_dir=str(tmp_path / f"logs_{tag}"))
    base.update(kw)
    return pretrain.PretrainingArgs(**base)


def _metrics(args):
    return [json.loads(line) for line in open(os.path.join(args.log_dir, "metrics.jsonl"))]


def _ctc(run_dir, name="for_ctc"):
    return Wav2Vec2ForCTC.from_pretrained(os.path.join(run_dir, name), device="cpu")


def test_pretrain_cli_end_to_end(corpus, config_json, tmp_path):
    """2 epochs of 2 updates (2 x 2 accumulated microbatches), EMA: finite
    losses, an annealing temperature, a checkpoint an epoch, and both
    exports load (in the port and in the JAX package) with the same head."""
    args = _args(config_json, tmp_path, "e2e", train_dir=corpus, batch_size_per_device=2,
                 grad_accum=2, ema_decay=0.5)
    pretrain.main(args)
    metrics = _metrics(args)
    losses = [m["pretrain/loss"] for m in metrics if "pretrain/loss" in m]
    assert len(losses) == 2 * 2 and np.all(np.isfinite(losses))
    temps = [m["pretrain/gumbel_temperature"] for m in metrics if "pretrain/gumbel_temperature" in m]
    assert temps[0] == 2.0 and all(a > b for a, b in zip(temps, temps[1:]))
    assert [m["pretrain/batches"] for m in metrics if "pretrain/batches" in m] == [4, 4]
    assert CheckpointManager(os.path.join(args.ckpt_dir, "pretrain")).all_steps() == \
        [1_000_000, 2_000_000]
    ctc, ema = _ctc(args.ckpt_dir), _ctc(args.ckpt_dir, "for_ctc_ema")
    assert torch.equal(ctc.lm_head.kernel, ema.lm_head.kernel)
    assert any(not torch.equal(a, b) for a, b in
               zip(ctc.wav2vec2.state_dict().values(), ema.wav2vec2.state_dict().values()))
    for model in (ctc, ema):
        with torch.no_grad():
            assert torch.isfinite(model(torch.zeros(1, SAMPLES))).all()
    jax_ctc = JaxWav2Vec2ForCTC.from_pretrained(os.path.join(args.ckpt_dir, "for_ctc"))
    assert np.isfinite(np.asarray(jax_ctc(np.zeros((1, SAMPLES), np.float32)))).all()


def test_pretrain_cli_tfrecords_and_resume_refusal(config_json, tmp_path, capsys):
    """A TFRecord stream (uncounted: the 500000-update horizon), and
    `--resume` on a directory with no checkpoint refuses."""
    rng = np.random.default_rng(7)
    shard = str(tmp_path / "train-0.tfrecord")
    with TFRecordWriter(shard) as w:
        for _ in range(8):
            w.write(rng.standard_normal(SAMPLES).astype(np.float32), np.asarray([5, 6, 7], np.int32))
    args = _args(config_json, tmp_path, "tfr", train_tfrecords=[shard], epochs=1)
    pretrain.main(args)
    assert "tfrecord stream length unknown" in capsys.readouterr().out
    assert os.path.isdir(os.path.join(args.ckpt_dir, "for_ctc"))
    empty = tmp_path / "nothing_here"
    empty.mkdir()
    with pytest.raises(ValueError, match="refusing to silently restart"):
        pretrain.main(_args(config_json, tmp_path, "tfr2", train_tfrecords=[shard],
                            resume=str(empty)))


def _preempt_after(monkeypatch, updates: int):
    """SIGTERM to this process after the `updates`-th pretraining update."""
    make = pretrain.make_pretrain_step
    done = []

    def make_step(*a, **kw):
        step = make(*a, **kw)

        def wrapped(*sa):
            out = step(*sa)
            done.append(1)
            if len(done) == updates:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    monkeypatch.setattr(pretrain, "make_pretrain_step", make_step)


def test_pretrain_cli_sigterm_then_resume_is_the_straight_run(corpus, config_json, tmp_path,
                                                               monkeypatch, capsys):
    """SIGTERM mid-epoch saves a step-granular checkpoint and exits; `--resume`
    fast-forwards the epoch's stream, completes, and ends on the straight
    run's weights bit for bit (the generator and the masks' microbatch count
    are part of the state)."""
    straight = _args(config_json, tmp_path, "straight", train_dir=corpus, ema_decay=0.5)
    pretrain.main(straight)

    cut = _args(config_json, tmp_path, "cut", train_dir=corpus, ema_decay=0.5)
    _preempt_after(monkeypatch, 5)  # epoch 1, update 1 of 4
    handler = signal.getsignal(signal.SIGTERM)
    pretrain.main(cut)
    assert signal.getsignal(signal.SIGTERM) is handler  # main restores it
    out = capsys.readouterr().out
    assert "preempted — saved epoch 1 update 1" in out
    assert CheckpointManager(os.path.join(cut.ckpt_dir, "pretrain")).latest_step() == 1_000_001
    assert not os.path.exists(os.path.join(cut.ckpt_dir, "for_ctc"))
    monkeypatch.undo()

    resumed = _args(config_json, tmp_path, "resumed", train_dir=corpus, ema_decay=0.5,
                    resume=cut.ckpt_dir)
    pretrain.main(resumed)
    assert "resumed epoch 1 (+1 updates)" in capsys.readouterr().out
    logged = [m["step"] for m in _metrics(resumed) if "pretrain/loss" in m]
    assert logged == [6, 7, 8]
    for name in ("for_ctc", "for_ctc_ema"):
        a, b = _ctc(straight.ckpt_dir, name).state_dict(), _ctc(cut.ckpt_dir, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name


def test_pretrain_cli_refuses_what_is_not_ported(config_json, tmp_path):
    """A model axis the processes cannot fill is refused (several processes
    and tensor parallelism run since they were ported: test_torch_parallel_cli)."""
    with pytest.raises(ValueError, match="model axis 2 does not divide device count 1"):
        pretrain.main(_args(config_json, tmp_path, "axis", model_axis=2))


def test_pretrain_parse_args_defaults_and_horizon():
    args = pretrain.parse_args(["--device", "cpu", "--no-remat", "--grad_accum", "3"])
    assert (args.device, args.remat, args.remat_policy, args.grad_accum) == ("cpu", False, "dots", 3)
    assert pretrain.parse_args([]).remat is True
    assert pretrain.horizon(pretrain.PretrainingArgs(epochs=2, grad_accum=3), 10) == 6
    assert pretrain.horizon(pretrain.PretrainingArgs(total_steps=7), 10) == 7
    assert pretrain.horizon(pretrain.PretrainingArgs(), None) == pretrain.STREAM_HORIZON
    robust = _port_config(tiny_pretraining_config(robust=True))
    assert isinstance(pretrain.ctc_config_of(robust), port_config.RobustWav2Vec2Config)


def _hf_mask_and_negatives(config, b, frames, seed=0):
    from transformers.models.wav2vec2.modeling_wav2vec2 import (
        _compute_mask_indices,
        _sample_negative_indices,
    )

    np.random.seed(seed)
    mask = _compute_mask_indices((b, frames), mask_prob=0.5, mask_length=2)
    negs = _sample_negative_indices((b, frames), config.num_negatives, mask_time_indices=mask)
    return torch.from_numpy(mask.astype(bool)), torch.from_numpy(negs.astype(np.int32))


@requires_transformers
@pytest.mark.parametrize("robust", [False, True])
def test_pretraining_forward_and_loss_match_hf_oracle(robust):
    """Eval forward (argmax quantizer, no dropout) and the full loss against
    the live HF model with the same weights, mask and negatives; the
    production `gram` loss and the `gather` one both."""
    import transformers

    cfg = tiny_pretraining_config(robust=robust)
    hf_config = matching_hf_config(cfg)
    hf_config.apply_spec_augment = True  # HF builds masked_spec_embed only then
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2ForPreTraining(hf_config).eval()
    pcfg = _port_config(cfg)
    model = pt.Wav2Vec2ForPreTraining(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_hf(hf.state_dict(), pcfg, with_lm_head=False,
                                             pretraining=True), strict=True)

    b, l = 2, 3200
    speech = torch.from_numpy(np.random.default_rng(1).standard_normal((b, l)).astype(np.float32))
    mask, negs = _hf_mask_and_negatives(pcfg, b, int(pcfg.conv_output_length(l)), seed=3)
    with torch.no_grad():
        out = hf(speech, mask_time_indices=mask, sampled_negative_indices=negs.long())
        states, quantized, perplexity, code_ids = pt.wav2vec2_for_pretraining_forward(
            model, pcfg, speech, mask, training=False, compute_dtype=torch.float32,
            return_code_ids=True)
    np.testing.assert_allclose(states.numpy(), out.projected_states.numpy(), atol=2e-4)
    np.testing.assert_allclose(quantized.numpy(), out.projected_quantized_states.numpy(), atol=2e-5)
    np.testing.assert_allclose(float(perplexity), float(out.codevector_perplexity), rtol=1e-5)
    for impl in ("gather", "gram"):
        parts = pt.pretraining_loss(states, quantized, perplexity, mask, negs, pcfg,
                                    code_ids=code_ids, contrastive_impl=impl)
        np.testing.assert_allclose(float(parts["contrastive_loss"]), float(out.contrastive_loss),
                                   rtol=2e-4, err_msg=impl)
        np.testing.assert_allclose(float(parts["diversity_loss"]), float(out.diversity_loss),
                                   rtol=1e-4, err_msg=impl)
        np.testing.assert_allclose(float(parts["loss"]), float(out.loss), rtol=2e-4, err_msg=impl)
