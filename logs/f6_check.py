"""F6 on the card: what `training.deterministic_training` costs, and whether
an f32 run under PyTorch's TF32 defaults stays within the f32 CPU copy's
bounds.  PYTHONPATH=. python3 logs/f6_check.py  (prints JSON lines)

1. The robust/large model (full width and depth, seed 0) in f32: row 0's
   logits and a stage-2 loss (dropout 0.1, SpecAugment, the mask; one
   generator) on the card under the TF32 flags PyTorch starts with and with
   TF32 off, each against the same on the f32 CPU copy (logits 4e-3, the
   JAX parity tests' bound).
2. Warmed steps timed by turns: the f32 robust stage-2 step (ragged B=8 x
   246000, no remat) under cuDNN's defaults, under `deterministic_training`,
   and under it with TF32 off; the bf16 base pretraining step (`gram`, B=8,
   every parameter trainable) under cuDNN's defaults and under
   `deterministic_training`.  Each reading is the median of 3 steps.
"""
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TF32_AT_START = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision": torch.get_float32_matmul_precision()}

import chip_smoke as cs  # noqa: E402
from gsoc_wav2vec2_tpu_torch.models import pretraining as pt  # noqa: E402

ROUNDS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def settings(det: bool, tf32: bool):
    torch.backends.cudnn.deterministic = det
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = tf32 and TF32_AT_START["cudnn.allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32 and TF32_AT_START["cuda.matmul.allow_tf32"]


def median_ms(fn, n=3):
    reps = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t) * 1e3)
    return statistics.median(reps)


def by_turns(name, fn, modes):
    """Readings of `fn` under each (label, det, tf32) of `modes`, in turns:
    the order, then its reverse, ROUNDS times."""
    got = {label: [] for label, _, _ in modes}
    for label, det, tf32 in modes:  # one warm step under each setting
        settings(det, tf32)
        fn()
    for _ in range(ROUNDS):
        for label, det, tf32 in modes + modes[::-1]:
            settings(det, tf32)
            got[label].append(median_ms(fn))
    emit({"what": name, "ms": got, "median_ms": {k: statistics.median(v) for k, v in got.items()}})


def robust_f32(smi):
    config = cs.RobustWav2Vec2Config()
    model = cs.Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(25)
    speech, lengths = cs._ragged_batch(rng, cs.ROBUST_B, cs.SAMPLES, 80000)
    mask = (np.arange(cs.SAMPLES)[None, :] < lengths[:, None]).astype(np.int32)
    batch = {"speech": speech, "labels": cs._labels(rng, cs.ROBUST_B, config.vocab_size, 120),
             "attention_mask": mask}
    kw = dict(with_attention_mask=True, length_aware=True, remat=False, compute_dtype=torch.float32)
    cs.set_trainable(model, cs.STAGE2)
    loss_fn = cs.make_ctc_loss_fn(config, division_factor=2, **kw)
    small = {k: v[:2] for k, v in batch.items()}
    x0 = torch.from_numpy(speech[:1])
    m0 = torch.ones(1, cs.SAMPLES)

    def card_row_and_loss():
        with torch.inference_mode():
            row = cs.wav2vec2_for_ctc_forward(model, config, x0.cuda(), m0.cuda(),
                                              compute_dtype=torch.float32)[0].cpu()
        with torch.no_grad():
            loss = loss_fn(model, small, torch.Generator().manual_seed(7)).item()
        return row, loss

    card = {}
    for label, tf32 in (("tf32_at_start", True), ("tf32_off", False)):
        settings(True, tf32)
        card[label] = card_row_and_loss()
    cpu = copy.deepcopy(model).to("cpu")
    torch.set_num_threads(8)
    t = time.perf_counter()
    with torch.inference_mode():
        ref = cs.wav2vec2_for_ctc_forward(cpu, config, x0, m0, compute_dtype=torch.float32)[0]
    with torch.no_grad():
        ref_loss = loss_fn(cpu, small, torch.Generator().manual_seed(7)).item()
    cpu_s = time.perf_counter() - t
    del cpu
    out = {}
    for label, (row, loss) in card.items():
        err, mean_err, scale, agree = cs.logits_vs(row, ref)
        out[label] = {"logits_max_abs_err": err, "logits_mean_abs_err": mean_err, "logit_scale": scale,
                      "argmax_agree": agree, "loss": loss, "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                      "within_4e-3": err <= 4e-3}
    emit({"what": "robust_f32 card vs f32 CPU copy (row 0 logits; stage-2 loss of 2 rows, "
                  "dropout 0.1, SpecAugment, mask)", "tf32_flags_at_start": TF32_AT_START,
          "cpu_loss": ref_loss, "cpu_s": cpu_s, "card": smi, **out})

    st = cs.create_train_state(model, cs.create_optimizer(model, 1e-4))
    step = cs.make_train_step(config, division_factor=cs.ROBUST_B, **kw)
    gen = torch.Generator().manual_seed(0)

    def one_step():
        step(st, batch, gen)[1]["loss"].item()

    by_turns("robust_f32 stage-2 step, B=8 (ms)", one_step,
             [("cudnn_defaults", False, True), ("deterministic", True, True),
              ("deterministic_tf32_off", True, False)])
    del st, model
    torch.cuda.empty_cache()


def pretrain_bf16(smi):
    config, args = cs.Wav2Vec2PretrainingConfig(), cs.PretrainingArgs(warmup_steps=8)
    model = cs.Wav2Vec2ForPreTraining(config, device="cuda", generator=torch.Generator().manual_seed(0))
    cs.set_trainable(model, ())
    batch, _ = cs._pretrain_batch(config, args, seed=21)
    st = cs.create_train_state(model, cs.create_pretrain_optimizer(
        model, 1e-5, weight_decay=args.weight_decay, eps=args.adam_eps))
    step = pt.make_pretrain_step(config, division_factor=cs.PRETRAIN_B, with_attention_mask=True,
                                 remat=False)
    gen = torch.Generator().manual_seed(0)

    def one_step():
        step(st, batch, gen, 2.0)[1]["loss"].item()

    by_turns("base pretraining step, bf16, gram, B=8 (ms)", one_step,
             [("cudnn_defaults", False, True), ("deterministic", True, True)])


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"card": smi, "tf32_flags_at_start": TF32_AT_START})
    cs._build.library()
    robust_f32(smi)
    pretrain_bf16(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
