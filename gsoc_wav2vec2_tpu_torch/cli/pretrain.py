"""Self-supervised pretraining CLI (counterpart of
`gsoc_wav2vec2_tpu/cli/pretrain.py`): the wav2vec2 paper's masked
contrastive + diversity objective over unlabeled audio, exporting a
backbone that `cli.train --model_id` fine-tunes.

The JAX CLI's recipe: AdamW with linear warmup then linear decay to 0
over the horizon (`--total_steps`, else the epochs' updates, else 500000 for
a TFRecord stream, whose length is not counted), the Gumbel temperature
annealed `max * decay^step` down to `min`, span masks over each row's real
frames drawn per microbatch from `seed + 7` and the microbatch count (so a
resumed run draws the same masks), gradient accumulation, EMA weights,
per-epoch full-state checkpoints under `<ckpt_dir>/pretrain`, SIGTERM
preemption (a mid-epoch checkpoint; `--resume` fast-forwards the epoch's
seeded stream past it) and `MetricLogger`.  At the end `for_ctc/` holds a
`Wav2Vec2ForCTC` (the backbone and a fresh head from `seed + 2`), and with
`--ema_decay` `for_ctc_ema/` the EMA backbone under the same head.

Through the port's kernels in bf16, with `--remat --remat_policy dots`
(`--compute_dtype float32` runs the flash kernels' f32 instance where the
head dim is 64 and every other site plain; `--device cpu` runs the f32
plain path).  On several cards, one process a
card under `torchrun`, as `cli.train` runs them: a (data, model) mesh, the
global batch `--batch_size_per_device` x ranks / model axis, each rank
loading its data group's rows in lockstep, the span masks drawn at the
global batch's shape and each rank taking its rows, the LR horizon the
smallest over ranks; rank 0 logs and exports.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.pretrain --train_dir ... --epochs 1
    torchrun --nproc_per_node 8 -m gsoc_wav2vec2_tpu_torch.cli.pretrain ...
(labels in the corpus are ignored; only audio is read.)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time
from dataclasses import asdict, dataclass, field
from typing import List, Optional

import torch

from ..data.loaders import LibriSpeechDataLoader, LibriSpeechDataLoaderArgs
from ..data.remote import expand_patterns
from ..models.config import (
    RobustWav2Vec2Config,
    RobustWav2Vec2PretrainingConfig,
    Wav2Vec2Config,
    Wav2Vec2PretrainingConfig,
)
from ..models.pretraining import (
    Wav2Vec2ForPreTraining,
    ctc_params_from_pretraining,
    make_pretrain_accum_steps,
    make_pretrain_step,
)
from ..ops.specaugment import _rows_of
from ..parallel import make_mesh, multihost, shard_params
from ..parallel.mesh import global_rows
from ..training import (
    create_pretrain_optimizer,
    create_train_state,
    pretrain_lr_schedule,
    set_learning_rate,
    set_trainable,
)
from ..training.checkpoint import CheckpointManager
from ..utils.devices import rank_device
from ..utils.logging import MetricLogger, NullLogger
from .train import (
    _CKPT_STRIDE,
    _DTYPES,
    PreemptExit,
    _compute_dtype,
    _lockstep,
    _preempt_consensus,
    _timed,
    install_preempt_handler,
    remat_value,
    whole_model,
)

STREAM_HORIZON = 500_000  # the LR horizon of an uncounted stream (wav2vec2-base's recipe)


@dataclass
class PretrainingArgs:
    """The JAX CLI's fields, defaults and env vars, plus `device`."""

    epochs: int = 1
    lr: float = 5e-4
    warmup_steps: int = 32000
    weight_decay: float = 0.01
    adam_eps: float = 1e-6

    # Gumbel temperature anneal (HF run_wav2vec2_pretraining_no_trainer.py
    # defaults: 2 -> 0.5, multiplicative decay per step)
    gumbel_temp_max: float = 2.0
    gumbel_temp_min: float = 0.5
    gumbel_temp_decay: float = 0.999995

    # pretraining masks aggressively (paper section 4.2: p=0.065 per start,
    # about 49% of frames; the HF config expresses it as mask_time_prob=0.65)
    mask_time_prob: float = 0.65
    mask_time_length: int = 10

    batch_size_per_device: int = 8
    # microbatches summed per optimizer update
    grad_accum: int = 1
    # EMA shadow weights (0 = off); the export gets a `for_ctc_ema/` sibling
    ema_decay: float = 0.0
    audio_maxlen: int = 246000
    # LR-decay horizon; 0 = epochs x updates an epoch when the loader counts
    # its batches, else the paper recipe's 500k steps
    total_steps: int = 0
    seed: int = 0
    logging_steps: int = 16
    ckpt_every_epochs: int = 1
    # several processes: the SIGTERM flag is all-gathered every N updates
    preempt_sync_updates: int = 25

    model_axis: int = 1
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "dots"

    train_tfrecords: List[str] = field(default_factory=list)
    train_dir: Optional[str] = None
    # a config.json of Wav2Vec2PretrainingConfig fields; None = the base one
    config: Optional[str] = None
    ckpt_dir: str = "pretrain_checkpoints"
    log_dir: str = "logs"
    wandb_project: Optional[str] = None
    # a previous run's ckpt_dir: continue from its latest checkpoint
    resume: Optional[str] = None
    # None: the card, LOCAL_RANK modulo the cards (raises without CUDA); "cpu" runs the
    # plain f32 path
    device: Optional[str] = None

    def __post_init__(self):
        bucket = os.environ.get("DATA_BUCKET_NAME")
        if bucket and not (self.train_tfrecords or self.train_dir):
            self.train_tfrecords = [os.path.join(bucket, "train", "*.tfrecord")]
        dummy = os.environ.get("DUMMY_DATA_PATH")
        if dummy and not (self.train_tfrecords or self.train_dir):
            self.train_dir = dummy
        ckpt_bucket = os.environ.get("CKPT_BUCKET_NAME")
        if ckpt_bucket:
            self.ckpt_dir = ckpt_bucket
        self.train_tfrecords = expand_patterns(self.train_tfrecords)


def gumbel_temperature(args: PretrainingArgs, step: int) -> float:
    return max(args.gumbel_temp_max * args.gumbel_temp_decay**step, args.gumbel_temp_min)


def batch_masks(generator: torch.Generator, attention_mask: torch.Tensor,
                config: Wav2Vec2PretrainingConfig, args: PretrainingArgs,
                rows=None) -> torch.Tensor:
    """Bool (B, frames) span mask for one batch, restricted to real frames:
    padded frames must never become contrastive targets or negatives (an
    utterance padded to `audio_maxlen` is often 20-70% padding).  On the
    attention mask's device.  `rows = (start, global_rows)`: a rank's rows of
    the global batch's draw (JAX draws the masks at the global batch)."""
    attention_mask = torch.as_tensor(attention_mask)
    b, samples = attention_mask.shape
    frames = int(config.conv_output_length(samples))
    frame_length = config.conv_output_length(attention_mask.to(torch.int64).sum(dim=-1))
    mask = _rows_of(generator, b, frames, args.mask_time_prob, args.mask_time_length, 2, rows)
    valid = torch.arange(frames, device=attention_mask.device)[None, :] < frame_length[:, None]
    return mask.to(attention_mask.device) & valid


def mask_generator(args: PretrainingArgs, microbatch: int) -> torch.Generator:
    """The span masks' generator of the run's `microbatch`-th microbatch
    (JAX: `fold_in(PRNGKey(seed + 7), microbatch)`): a resumed run draws
    the straight run's masks."""
    return torch.Generator().manual_seed(((args.seed + 7) << 32) + microbatch)


def horizon(args: PretrainingArgs, batches_per_epoch: Optional[int]) -> int:
    """Updates the LR decays over: `--total_steps`, else the epochs' updates
    (`batches // grad_accum` each), else `STREAM_HORIZON`."""
    if args.total_steps > 0:
        return args.total_steps
    if batches_per_epoch is not None:
        return max(batches_per_epoch // args.grad_accum * args.epochs, 1)
    print(f"tfrecord stream length unknown: LR decays over {STREAM_HORIZON} steps "
          "(--total_steps overrides)")
    return STREAM_HORIZON


def load_config(args: PretrainingArgs) -> Wav2Vec2PretrainingConfig:
    if args.config is None:
        return Wav2Vec2PretrainingConfig()
    config = Wav2Vec2PretrainingConfig.from_json(args.config)
    return RobustWav2Vec2PretrainingConfig(**asdict(config)) if config.is_robust else config


def ctc_config_of(config: Wav2Vec2PretrainingConfig) -> Wav2Vec2Config:
    """The fine-tuning config of the same geometry, so that `cli.train`'s
    `from_pretrained(for_ctc)` reads the config.json back."""
    cls = RobustWav2Vec2Config if config.is_robust else Wav2Vec2Config
    return cls(**{f.name: getattr(config, f.name) for f in dataclasses.fields(Wav2Vec2Config)})


def _export(model, ema_params, config, args: PretrainingArgs) -> None:
    """`for_ctc/` (and `for_ctc_ema/`) from whole weights."""
    ctc_config = ctc_config_of(config)
    out_dir = os.path.join(args.ckpt_dir, "for_ctc")
    head = lambda: torch.Generator().manual_seed(args.seed + 2)  # noqa: E731
    ctc_params_from_pretraining(model, ctc_config, head()).save_pretrained(out_dir)
    print(f"saved fine-tune-ready model to {out_dir}")
    if ema_params is not None:
        ema = Wav2Vec2ForPreTraining(config, device="cpu")
        ema.load_state_dict(ema_params, strict=True)
        ema_dir = os.path.join(args.ckpt_dir, "for_ctc_ema")
        # the same head: the EMA export differs from for_ctc in the backbone only
        ctc_params_from_pretraining(ema, ctc_config, head()).save_pretrained(ema_dir)
        print(f"saved EMA (decay {args.ema_decay}) fine-tune-ready model to {ema_dir}")


def main(args: PretrainingArgs, config: Optional[Wav2Vec2PretrainingConfig] = None) -> None:
    device = rank_device(args.device)
    multihost.initialize(device)  # nothing to do for one process
    mesh = make_mesh(model=args.model_axis)
    if args.grad_accum < 1:
        raise ValueError(f"--grad_accum must be >= 1, got {args.grad_accum}")
    if not 0.0 <= args.ema_decay < 1.0:
        raise ValueError(f"--ema_decay must be in [0, 1), got {args.ema_decay}")
    remat = remat_value(args)
    compute_dtype = _compute_dtype(args)
    if not (args.train_tfrecords or args.train_dir):
        raise ValueError("no training data: pass --train_tfrecords or --train_dir")
    config = config if config is not None else load_config(args)
    lead = multihost.rank() == 0
    # --batch_size_per_device x ranks / model axis; each rank loads its data group's rows
    global_batch, accum = args.batch_size_per_device * mesh.data, args.grad_accum
    if global_batch % multihost.world_size():
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{multihost.world_size()} processes")

    loader = LibriSpeechDataLoader(LibriSpeechDataLoaderArgs(
        from_tfrecords=bool(args.train_tfrecords), tfrecords=args.train_tfrecords or None,
        data_dir=args.train_dir, batch_size=global_batch // mesh.data,
        audio_maxlen=args.audio_maxlen), shard_index=mesh.data_index, shard_count=mesh.data)
    # the ranks' shards can differ by a batch: every rank takes the smallest
    # horizon (`lockstep_batches` drains that many)
    steps_per_epoch = multihost.sync_min_count(loader.num_batches(drop_remainder=True))
    schedule = pretrain_lr_schedule(args.lr, args.warmup_steps, horizon(args, steps_per_epoch))

    model = Wav2Vec2ForPreTraining(config, device=device,
                                   generator=torch.Generator().manual_seed(args.seed))
    shard_params(model, mesh)
    set_trainable(model, ())
    state = create_train_state(
        model, create_pretrain_optimizer(model, args.lr, weight_decay=args.weight_decay,
                                         eps=args.adam_eps),
        ema=args.ema_decay > 0, generator=torch.Generator().manual_seed(args.seed + 1))
    if args.resume is not None:
        args.ckpt_dir = args.resume  # continue inside the previous run's directory
    ckpt = CheckpointManager(os.path.join(args.ckpt_dir, "pretrain"), mesh=mesh)
    start_epoch = skip_updates = 0
    if args.resume is not None:
        last = ckpt.latest_step()
        if last is None:
            raise ValueError(
                f"--resume {args.resume}: no checkpoint found under "
                f"{os.path.join(args.ckpt_dir, 'pretrain')} — refusing to silently restart "
                "from scratch")
        ckpt.restore(state)
        start_epoch, skip_updates = divmod(int(last), _CKPT_STRIDE)
        at = f" (+{skip_updates} updates)" if skip_updates else ""
        print(f"pretrain: resumed epoch {start_epoch}{at} from {args.resume}")

    step_kwargs = dict(division_factor=global_batch * accum,  # SUM over the effective batch
                       with_attention_mask=True, compute_dtype=compute_dtype, remat=remat,
                       ema_decay=args.ema_decay if args.ema_decay > 0 else None, mesh=mesh)
    if accum == 1:
        step_fn = make_pretrain_step(config, **step_kwargs)
    else:
        init_fn, accum_fn, apply_fn = make_pretrain_accum_steps(config, **step_kwargs)
    gen = state.generator
    step_count = state.step
    logger = (MetricLogger(args.log_dir, project=args.wandb_project, config=asdict(args))
              if lead else NullLogger())
    previous = install_preempt_handler()  # SIGTERM -> mid-epoch checkpoint + clean exit
    try:
        for epoch in range(start_epoch, args.epochs):
            epoch_start = time.time()
            epoch_batches = 0
            waits: list = []
            # mid-epoch resume: fast-forward the seeded stream past the
            # updates the checkpoint holds
            skip_micro = skip_updates * accum if epoch == start_epoch else 0
            epoch_updates = skip_updates if epoch == start_epoch else 0
            micro = 0
            batches = _lockstep(loader, loader(seed=args.seed + epoch, drop_remainder=True))
            for batch in _timed(batches, waits):
                epoch_batches += 1
                if skip_micro > 0:
                    skip_micro -= 1
                    continue
                batch = multihost.host_local_batch_to_global(
                    {"speech": batch["speech"], "attention_mask": batch["attention_mask"]},
                    mesh, global_batch)
                batch["mask_time_indices"] = batch_masks(
                    mask_generator(args, step_count * accum + micro), batch["attention_mask"],
                    config, args, rows=global_rows(mesh, len(batch["speech"])))
                temp = gumbel_temperature(args, step_count)
                if micro == 0:
                    # optax counts from 0: the first update runs at the schedule's 0
                    set_learning_rate(state.optimizer, schedule(state.step))
                if accum == 1:
                    state, metrics = step_fn(state, batch, gen, temp)
                else:
                    if micro == 0:
                        metrics_acc = init_fn(state)
                    metrics_acc = accum_fn(state, batch, gen, temp, metrics_acc)
                    micro += 1
                    if micro < accum:
                        continue  # update incomplete: keep accumulating
                    micro = 0
                    state, metrics = apply_fn(state, metrics_acc)
                epoch_updates += 1
                step_count += 1
                if step_count % args.logging_steps == 0:
                    logger.log({
                        "pretrain/loss": float(metrics["loss"]),
                        "pretrain/contrastive": float(metrics["contrastive_loss"]),
                        "pretrain/diversity": float(metrics["diversity_loss"]),
                        # accumulated metrics are sums over the update's microbatches
                        "pretrain/perplexity": float(metrics["codevector_perplexity"]) / accum,
                        "pretrain/gumbel_temperature": temp,
                        "epoch": epoch,
                    }, step=step_count)
                if _preempt_consensus(epoch_updates, args.preempt_sync_updates):
                    key = epoch * _CKPT_STRIDE + epoch_updates
                    ckpt.save(key, state, wait=True)
                    print(f"pretrain: preempted — saved epoch {epoch} update {epoch_updates} "
                          f"(key {key}); resume with --resume to continue bit-exactly",
                          flush=True)
                    raise PreemptExit
            if micro > 0:
                print(f"pretrain epoch {epoch}: dropped {micro} trailing microbatch(es) "
                      f"short of --grad_accum {accum}")
            if epoch_batches == 0:
                raise RuntimeError("pretraining loader produced no batches — fewer samples "
                                   "than the global batch, or no audio found")
            if epoch_updates == 0:
                raise RuntimeError(
                    f"pretrain epoch {epoch}: {epoch_batches} microbatch(es) never completed "
                    f"an optimizer update — the epoch yields fewer batches than --grad_accum "
                    f"{accum}; reduce --grad_accum or the batch size")
            if (epoch + 1) % max(args.ckpt_every_epochs, 1) == 0 or epoch + 1 == args.epochs:
                ckpt.save((epoch + 1) * _CKPT_STRIDE, state)
            logger.log({"pretrain/epoch_time": time.time() - epoch_start,
                        "pretrain/data_wait_s": float(sum(waits)),
                        "pretrain/batches": epoch_batches, "epoch": epoch}, step=step_count)
    except KeyboardInterrupt:
        print("pretraining interrupted — saving progress")
    except PreemptExit:
        print("preempted: checkpoint saved; rerun with --resume", flush=True)
        logger.finish()
        return
    finally:
        signal.signal(signal.SIGTERM, previous)
    if mesh.model > 1:
        ema = state.ema_params
        model = whole_model(model, mesh)
        ema_params = None if ema is None else whole_model(state.model, mesh, ema).state_dict()
    else:
        ema_params = state.ema_params
    if lead:
        _export(model, ema_params, config, args)
    multihost.barrier()
    logger.finish()


def parse_args(argv=None) -> PretrainingArgs:
    parser = argparse.ArgumentParser("wav2vec2 self-supervised pretraining (PyTorch port)")
    defaults = PretrainingArgs()
    for name in ("epochs", "warmup_steps", "mask_time_length", "batch_size_per_device",
                 "grad_accum", "audio_maxlen", "seed", "total_steps", "logging_steps",
                 "ckpt_every_epochs", "model_axis", "preempt_sync_updates"):
        parser.add_argument(f"--{name}", type=int, default=getattr(defaults, name))
    for name in ("lr", "weight_decay", "adam_eps", "gumbel_temp_max", "gumbel_temp_min",
                 "gumbel_temp_decay", "mask_time_prob", "ema_decay"):
        parser.add_argument(f"--{name}", type=float, default=getattr(defaults, name))
    parser.add_argument("--compute_dtype", type=str, default="bfloat16", choices=sorted(_DTYPES))
    parser.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True,
                        help="recompute each encoder layer in the backward")
    parser.add_argument("--remat_policy", type=str, default="dots", choices=["full", "dots"])
    parser.add_argument("--train_tfrecords", nargs="*", default=[])
    parser.add_argument("--train_dir", type=str, default=None)
    parser.add_argument("--config", type=str, default=None,
                        help="config.json with Wav2Vec2PretrainingConfig fields")
    parser.add_argument("--ckpt_dir", type=str, default="pretrain_checkpoints")
    parser.add_argument("--log_dir", type=str, default="logs")
    parser.add_argument("--wandb_project", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None, metavar="CKPT_DIR",
                        help="a previous run's --ckpt_dir: continue from its latest checkpoint")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default: bf16 kernels, under torchrun the "
                             "card LOCAL_RANK modulo the cards) or cpu (f32 plain path)")
    return PretrainingArgs(**vars(parser.parse_args(argv)))


def cli_main() -> None:
    main(parse_args())


if __name__ == "__main__":
    cli_main()
