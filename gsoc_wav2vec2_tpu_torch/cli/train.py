"""Two-stage CTC fine-tuning driver (counterpart of
`gsoc_wav2vec2_tpu/cli/train.py`, the reference's `src/main.py`).

Env-var-configurable `TrainingArgs`, LibriSpeech train / val / test loaders
and the two-stage recipe (reference `main.py:204-255`,
`training_utils.py:24-31`): stage 1 freezes the backbone (Adam 1e-3, the LM
head trains), stage 2 freezes the conv front end (Adam 1e-4, then 5e-5
after `transition_epoch`).  Per-`logging_steps` metrics, per-epoch full-state
checkpoints, a validation loss per epoch, the test loss, `final/` written by
`save_pretrained`.

Checkpoint keys are `epochs * _CKPT_STRIDE + updates`: SIGTERM saves
mid-epoch, and `--resume` skips the updates that checkpoint already holds in
that epoch's `seed + epoch` batch stream, so a resumed run is the straight
run bit for bit (the step's generator is part of the checkpoint).

Through the port's kernels in bf16 (`--compute_dtype float32` runs the
flash kernels' f32 instances at head dims 64-256, as JAX runs its Pallas
flash kernels on f32 inputs, and every other site plain), with cuDNN held
to deterministic algorithms (`training.deterministic_training`), with
JAX's `--remat --remat_policy dots` by default (each
encoder layer recomputed in the backward, its matrix products kept).  On
several cards, one process a card under `torchrun`: a (data, model) mesh
with `--model_axis` ranks a tensor-parallel group (`parallel/`), the global
batch `--batch_size_per_device` x ranks / model axis, each rank loading its
data group's rows, the streams in lockstep, the SIGTERM flag all-gathered
every `--preempt_sync_updates` updates; rank 0 logs and writes `final/`,
checkpoints hold whole tensors (any layout resumes any other).

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.train --model_id <dir> \\
        --train_tfrecords 'train/*.tfrecord' --val_tfrecords 'dev/*.tfrecord'
    torchrun --nproc_per_node 8 -m gsoc_wav2vec2_tpu_torch.cli.train \\
        --model_axis 2 ...
(env vars DATA_BUCKET_NAME / CKPT_BUCKET_NAME / DUMMY_DATA_PATH are
honoured, as in the reference's `main.py:24-27`.)
"""

from __future__ import annotations

import argparse
import os
import signal
import time
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Union

import numpy as np
import torch

from ..data.loaders import LibriSpeechDataLoader, LibriSpeechDataLoaderArgs
from ..data.remote import expand_patterns
from ..models.config import Wav2Vec2Config
from ..models.modeling import Wav2Vec2ForCTC, wav2vec2_for_ctc_forward
from ..ops.ctc import ctc_loss_fn
from ..parallel import make_mesh, multihost, shard_params, unshard_state_dict
from ..parallel.mesh import Mesh
from ..training import (
    create_optimizer,
    create_train_state,
    deterministic_training,
    make_grad_accum_steps,
    make_train_step,
    set_learning_rate,
    set_trainable,
)
from ..training.checkpoint import CheckpointManager
from ..training.trainer import _to_device, data_sum
from ..utils.devices import rank_device
from ..utils.logging import MetricLogger, NullLogger

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainingArgs:
    """The JAX driver's fields, defaults and env vars (reference
    `main.py:30-125`), plus `device`."""

    # stage 1 trains only the LM head; stage 2 unfreezes all but the convs
    stage1_epochs: int = 15
    stage1_lr: float = 1e-3
    stage2_epochs: int = 15
    stage2_lr1: float = 1e-4
    stage2_lr2: float = 5e-5
    transition_epoch: int = 10

    batch_size_per_device: int = 32
    # microbatches summed per optimizer update (the division factor is the
    # effective batch, so the update equals one step on the whole batch)
    grad_accum: int = 1
    # EMA of the weights (0 = off); restarts at each stage's initial weights,
    # the final save also writes `<run>/final_ema`
    ema_decay: float = 0.0
    audio_maxlen: int = 246000  # multiple of 128 frames, `main.py:48-51`
    labels_maxlen: int = 256
    seed: int = 0
    logging_steps: int = 16
    # trace N optimizer updates per stage with torch.profiler, from the 2nd
    # update on; a Chrome trace per stage under <log_dir>/trace
    profile_steps: int = 0

    # checkpoint cadence in epochs; the final epoch always checkpoints
    ckpt_every_epochs: int = 1
    # several processes: the SIGTERM flag is all-gathered every N updates
    preempt_sync_updates: int = 25

    model_id: Optional[str] = None  # from_pretrained source; None = seeded init
    model_axis: int = 1
    # bucketed training: sorted audio lengths; each batch pads to its bucket
    # and the loss goes length-aware
    bucket_boundaries: List[int] = field(default_factory=list)
    compute_dtype: str = "bfloat16"
    length_aware_loss: bool = False
    # per-layer rematerialisation: "dots" keeps the matrix products, "full"
    # recomputes the whole layer
    remat: bool = True
    remat_policy: str = "dots"

    train_tfrecords: List[str] = field(default_factory=list)
    val_tfrecords: List[str] = field(default_factory=list)
    test_tfrecords: List[str] = field(default_factory=list)
    train_dir: Optional[str] = None
    val_dir: Optional[str] = None
    test_dir: Optional[str] = None

    ckpt_dir: str = "checkpoints"
    log_dir: str = "logs"
    wandb_project: Optional[str] = None
    # a previous run's experiment dir (.../experiment-<id>): each stage
    # restores its latest checkpoint and continues
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
        for name in ("train_tfrecords", "val_tfrecords", "test_tfrecords"):
            setattr(self, name, expand_patterns(getattr(self, name)))


_CKPT_STRIDE = 1_000_000

_PREEMPT_REQUESTED = False


def _on_sigterm(signum, frame):  # noqa: ARG001
    global _PREEMPT_REQUESTED
    _PREEMPT_REQUESTED = True


def install_preempt_handler():
    """SIGTERM sets the preemption flag; returns the handler it replaced."""
    global _PREEMPT_REQUESTED
    _PREEMPT_REQUESTED = False
    return signal.signal(signal.SIGTERM, _on_sigterm)


class PreemptExit(Exception):
    """Raised after a preemption checkpoint; aborts the remaining stages."""


def _preempt_consensus(update_idx: int, sync_every: int) -> bool:
    """Do all ranks agree to stop now?  One process: the local flag, checked
    every update.  Several: every rank must checkpoint at the same update,
    so the flag is all-gathered every `sync_every` updates (none between)."""
    if multihost.world_size() == 1:
        return _PREEMPT_REQUESTED
    if update_idx % max(sync_every, 1) != 0:
        return False
    return multihost.max_flag(_PREEMPT_REQUESTED)


def remat_value(args) -> Union[bool, str]:
    """`--remat` / `--remat_policy` as the step builders' `remat` (JAX's
    mapping: "full" is True)."""
    if args.remat_policy not in ("full", "dots"):
        raise ValueError(f"--remat_policy must be 'full' or 'dots', got {args.remat_policy!r}")
    if not args.remat:
        return False
    return True if args.remat_policy == "full" else args.remat_policy


def _compute_dtype(args: TrainingArgs) -> torch.dtype:
    if args.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {args.compute_dtype!r}")
    return _DTYPES[args.compute_dtype]


def _global_batch(args: TrainingArgs, mesh: Mesh) -> int:
    """`--batch_size_per_device` x ranks / model axis (JAX `cli/train.py:157`)."""
    return args.batch_size_per_device * mesh.data


def _loader(args: TrainingArgs, tfrecords, data_dir, mesh: Optional[Mesh] = None):
    if not tfrecords and not data_dir:
        return None
    mesh = make_mesh() if mesh is None else mesh
    global_batch = _global_batch(args, mesh)
    if global_batch % multihost.world_size():
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{multihost.world_size()} processes")
    # each rank loads its data group's rows of the global batch (the ranks of
    # a model group load the same ones): --batch_size_per_device of them
    largs = LibriSpeechDataLoaderArgs(
        from_tfrecords=bool(tfrecords), tfrecords=tfrecords or None, data_dir=data_dir,
        batch_size=args.batch_size_per_device, audio_maxlen=args.audio_maxlen,
        labels_maxlen=args.labels_maxlen, bucket_boundaries=args.bucket_boundaries or None,
    )
    return LibriSpeechDataLoader(largs, shard_index=mesh.data_index, shard_count=mesh.data)


def _build_model(args: TrainingArgs, device) -> Wav2Vec2ForCTC:
    if args.model_id:
        return Wav2Vec2ForCTC.from_pretrained(args.model_id, device=device)
    return Wav2Vec2ForCTC(Wav2Vec2Config(), device=device,
                          generator=torch.Generator().manual_seed(args.seed))


def _lockstep(loader, batches):
    """A loader's stream in lockstep over the ranks (bucketed: at each step's
    longest bucket)."""
    if getattr(loader, "bucket_boundaries", None):
        return multihost.lockstep_bucket_batches(batches, repad=loader.repad_batch)
    return multihost.lockstep_batches(batches,
                                      num_batches=loader.num_batches(drop_remainder=True))


def whole_model(model, mesh: Mesh, state_dict=None):
    """A CPU copy of `model` with whole tensors (every rank calls it: the
    split parameters are gathered over the model group); `state_dict`
    (name -> shard, e.g. EMA weights) replaces the model's own."""
    whole = unshard_state_dict(model.state_dict() if state_dict is None else state_dict, mesh)
    copy = type(model)(model.config, device="cpu")
    copy.load_state_dict({k: v.detach().cpu() for k, v in whole.items()}, strict=True)
    return copy


def _timed(batches, waits: list):
    """Yield from `batches`, appending the host seconds each one was waited for."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t0)
        yield batch


class _StageProfiler:
    """`--profile_steps`: torch.profiler over updates [2, 2 + N) of a stage
    (the first update builds the kernels), written as a Chrome trace."""

    def __init__(self, steps: int, path: str, cuda: bool):
        self.pending, self.path, self.cuda = steps, path, cuda
        self.prof = None

    def tick(self, updates_done: int) -> None:
        if not self.pending:
            return
        if self.prof is None:
            if updates_done >= 1:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.cuda:
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                self.prof = torch.profiler.profile(activities=activities)
                self.prof.start()
            return
        self.pending -= 1
        if self.pending <= 0:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof, self.pending = None, 0
        print(f"profiler trace written to {self.path}", flush=True)


def run_stage(*, stage: int, args: TrainingArgs, config: Wav2Vec2Config, model,
              train_loader, val_loader, logger: MetricLogger, epochs: Optional[int] = None,
              mesh: Optional[Mesh] = None):
    """One fine-tuning stage, updating `model` (this rank's shards under a
    `mesh`) in place; returns `(model, ema_params)`, `ema_params` None unless
    `args.ema_decay > 0`."""
    mesh = make_mesh() if mesh is None else mesh
    epochs = epochs if epochs is not None else (
        args.stage1_epochs if stage == 1 else args.stage2_epochs)
    if epochs <= 0 or train_loader is None:
        return model, None

    global_batch = _global_batch(args, mesh)
    if stage == 1:
        frozen, lr0 = ("wav2vec2",), args.stage1_lr  # reference `main.py:210`
    else:
        frozen, lr0 = ("feature_extractor",), args.stage2_lr1  # `main.py:236-237`

    def stage_lr(epoch: int) -> float:
        if stage == 1:
            return args.stage1_lr
        return args.stage2_lr1 if epoch <= args.transition_epoch else args.stage2_lr2

    set_trainable(model, frozen)
    # the step's randomness: one generator a stage, as the JAX driver's
    # PRNGKey(seed + stage); its state is checkpointed with the weights
    state = create_train_state(model, create_optimizer(model, lr0), ema=args.ema_decay > 0,
                               generator=torch.Generator().manual_seed(args.seed + stage))
    ckpt = CheckpointManager(os.path.join(args.ckpt_dir, f"stage{stage}"), mesh=mesh)
    start_epoch = skip_updates = 0
    if args.resume is not None:
        last = ckpt.latest_step()
        if last is not None:
            ckpt.restore(state)
            start_epoch, skip_updates = divmod(int(last), _CKPT_STRIDE)
            at = f" (+{skip_updates} updates)" if skip_updates else ""
            print(f"stage {stage}: resumed epoch {start_epoch}{at} from {args.resume}")
    if start_epoch >= epochs:
        return model, state.ema_params

    bucketed = bool(args.bucket_boundaries)
    accum = max(args.grad_accum, 1)
    step_kwargs = dict(
        # each update sums `accum` microbatch losses: the division factor is
        # the effective batch (reference SUM / global batch, `main.py:196-200`)
        division_factor=global_batch * accum,
        # bucket padding stays out of the loss through the mask + lengths
        with_attention_mask=config.is_robust or args.length_aware_loss or bucketed,
        length_aware=args.length_aware_loss or bucketed,
        compute_dtype=_compute_dtype(args),
        ema_decay=args.ema_decay if args.ema_decay > 0 else None,
        remat=remat_value(args),
        mesh=mesh,
    )
    if accum == 1:
        step_fn = make_train_step(config, **step_kwargs)
    else:
        init_fn, accum_fn, apply_fn = make_grad_accum_steps(config, **step_kwargs)
    gen = state.generator
    step_count = state.step
    profiler = _StageProfiler(args.profile_steps if multihost.rank() == 0 else 0,
                              os.path.join(args.log_dir, "trace", f"stage{stage}.json"),
                              model.device.type == "cuda")
    interrupted = False
    for epoch in range(start_epoch, epochs):
        lr = stage_lr(epoch)
        set_learning_rate(state.optimizer, lr)
        epoch_start = time.time()
        epoch_batches = 0
        waits: list = []
        # mid-epoch resume: the first `skip_updates * accum` microbatches of
        # this epoch's seeded stream are in the checkpoint already
        skip_micro = skip_updates * accum if epoch == start_epoch else 0
        epoch_updates = skip_updates if epoch == start_epoch else 0
        micro = 0
        try:
            batches = _lockstep(train_loader,
                                train_loader(seed=args.seed + epoch, drop_remainder=True))
            for batch in _timed(batches, waits):
                epoch_batches += 1
                if skip_micro > 0:
                    skip_micro -= 1
                    continue
                batch = multihost.host_local_batch_to_global(
                    {k: batch[k] for k in ("speech", "labels", "attention_mask")}, mesh,
                    global_batch)
                if accum == 1:
                    state, metrics = step_fn(state, batch, gen)
                else:
                    if micro == 0:
                        loss_acc = init_fn(state)
                    loss_acc = accum_fn(state, batch, gen, loss_acc)
                    micro += 1
                    if micro < accum:
                        continue
                    micro = 0
                    state, metrics = apply_fn(state, loss_acc)
                epoch_updates += 1
                step_count += 1
                profiler.tick(epoch_updates)
                if step_count % args.logging_steps == 0:
                    logger.log({f"stage{stage}/loss": float(metrics["loss"]),
                                f"stage{stage}/grad_norm": float(metrics["grad_norm"]),
                                f"stage{stage}/lr": lr, "epoch": epoch}, step=step_count)
                if _preempt_consensus(epoch_updates, args.preempt_sync_updates):
                    profiler.stop()
                    key = epoch * _CKPT_STRIDE + epoch_updates
                    ckpt.save(key, state, wait=True)
                    print(f"stage {stage}: preempted — saved epoch {epoch} update "
                          f"{epoch_updates} (key {key}); resume with --resume to continue "
                          "bit-exactly", flush=True)
                    raise PreemptExit
            if micro > 0:
                # a partial SUM against the fixed division factor would
                # under-weigh the update: drop it, as the JAX driver does
                print(f"stage {stage} epoch {epoch}: dropped {micro} trailing "
                      f"microbatch(es) short of --grad_accum {accum}")
        except KeyboardInterrupt:
            # graceful per-stage skip, as in the reference (`main.py:225-226`)
            print(f"stage {stage} interrupted at epoch {epoch} — moving on")
            interrupted = True
        if interrupted:
            break
        if epoch_batches == 0:
            raise RuntimeError(
                f"stage {stage} epoch {epoch}: training loader produced no batches (fewer "
                f"samples than the global batch of {global_batch}, or no matched "
                "audio/transcript pairs) — refusing to train silently on nothing")
        if epoch_updates == 0:
            raise RuntimeError(
                f"stage {stage} epoch {epoch}: {epoch_batches} microbatch(es) never "
                "completed an optimizer update — the epoch yields fewer batches than "
                f"--grad_accum {accum}; reduce --grad_accum or the batch size")
        if val_loader is not None:
            val_loss = evaluate_loss(config, model, val_loader, args, mesh)
            logger.log({f"stage{stage}/val_loss": val_loss, "epoch": epoch}, step=step_count)
        if (epoch + 1) % max(args.ckpt_every_epochs, 1) == 0 or epoch + 1 == epochs:
            ckpt.save((epoch + 1) * _CKPT_STRIDE, state)
        logger.log({f"stage{stage}/epoch_time": time.time() - epoch_start,
                    f"stage{stage}/data_wait_s": float(sum(waits)),
                    f"stage{stage}/batches": epoch_batches, "epoch": epoch}, step=step_count)
    profiler.stop()  # the stage ended (or was interrupted) before N updates
    return model, state.ema_params


def evaluate_loss(config, model, loader, args: TrainingArgs,
                  mesh: Optional[Mesh] = None) -> float:
    """Mean over the loader's batches of the per-batch CTC loss (SUM over
    the batch / batch size, the reference's constant logit length; reference
    `model.evaluate`, `main.py:258`), eval forward in `--compute_dtype`.
    Under a `mesh` the ranks run their rows in lockstep and each batch's sum
    is added over the data group: every rank returns the global loss."""
    dtype = _compute_dtype(args)
    losses = []
    with torch.inference_mode():
        for batch in _lockstep(loader, loader(drop_remainder=True)):
            batch = _to_device(batch, model.device)
            mask = batch["attention_mask"] if config.is_robust else None
            logits = wav2vec2_for_ctc_forward(model, config, batch["speech"].float(), mask,
                                              compute_dtype=dtype, mesh=mesh)
            b, t = logits.shape[0], logits.shape[1]
            per_sample = ctc_loss_fn(logits, batch["labels"], torch.full((b,), t), config.pad_id)
            rows = b if mesh is None else b * mesh.data
            losses.append(float(data_sum(per_sample.sum(), mesh) / rows))
    return float(np.mean(losses)) if losses else float("nan")


def main(args: TrainingArgs) -> None:
    np.random.seed(args.seed)
    if args.grad_accum < 1:
        raise ValueError(f"--grad_accum must be >= 1, got {args.grad_accum}")
    if not 0.0 <= args.ema_decay < 1.0:
        raise ValueError(f"--ema_decay must be in [0, 1), got {args.ema_decay}")
    remat_value(args)
    _compute_dtype(args)
    deterministic_training()
    device = rank_device(args.device)
    multihost.initialize(device)  # nothing to do for one process
    model = _build_model(args, device)
    config = model.config
    if args.model_axis > 1 and (config.num_heads % args.model_axis
                                or config.intermediate_size % args.model_axis):
        raise ValueError(
            f"--model_axis {args.model_axis} must divide num_heads ({config.num_heads}) and "
            f"intermediate_size ({config.intermediate_size}) for tensor-parallel sharding")
    mesh = make_mesh(model=args.model_axis)
    lead = multihost.rank() == 0
    if lead:
        print(f"mesh: {mesh.shape}, processes: {multihost.world_size()}")
    shard_params(model, mesh)
    train_loader = _loader(args, args.train_tfrecords, args.train_dir, mesh)
    val_loader = _loader(args, args.val_tfrecords, args.val_dir, mesh)
    test_loader = _loader(args, args.test_tfrecords, args.test_dir, mesh)
    if train_loader is None:
        raise ValueError("no training data: pass --train_tfrecords or --train_dir")

    logger = (MetricLogger(args.log_dir, project=args.wandb_project, config=asdict(args))
              if lead else NullLogger())
    # continue inside the previous run's experiment dir, or start a new one
    run_dir = args.resume or os.path.join(
        args.ckpt_dir, f"experiment-{multihost.sync_run_id(logger.run_id)}")
    args.ckpt_dir = run_dir

    previous = install_preempt_handler()  # SIGTERM -> mid-epoch checkpoint + clean exit
    try:
        ema_params = None
        for stage in (1, 2):
            print(f"=== stage {stage} ===")
            model, stage_ema = run_stage(stage=stage, args=args, config=config, model=model,
                                         train_loader=train_loader, val_loader=val_loader,
                                         logger=logger, mesh=mesh)
            if stage_ema is not None:  # the last stage that ran
                ema_params = stage_ema
    except PreemptExit:
        logger.finish()
        print("preempted: checkpoint saved; rerun with --resume", flush=True)
        return
    finally:
        signal.signal(signal.SIGTERM, previous)

    if test_loader is not None:
        test_loss = evaluate_loss(config, model, test_loader, args, mesh)
        logger.log({"test_loss": test_loss})
        if lead:
            print(f"test loss: {test_loss:.4f}")

    final_dir = os.path.join(run_dir, "final")
    final = model if mesh.model == 1 else whole_model(model, mesh)
    ema_model = None if ema_params is None else whole_model(model, mesh, ema_params)
    if lead:
        final.save_pretrained(final_dir)
        print(f"saved final model to {final_dir}")
        if ema_model is not None:
            ema_dir = os.path.join(run_dir, "final_ema")
            ema_model.save_pretrained(ema_dir)
            print(f"saved EMA model (decay {args.ema_decay}) to {ema_dir}")
    multihost.barrier()
    logger.finish()


def parse_args(argv=None) -> TrainingArgs:
    parser = argparse.ArgumentParser("Two-stage wav2vec2 CTC fine-tuning (PyTorch port)")
    defaults = TrainingArgs()
    for name in ("stage1_epochs", "stage2_epochs", "transition_epoch", "batch_size_per_device",
                 "grad_accum", "audio_maxlen", "labels_maxlen", "seed", "logging_steps",
                 "ckpt_every_epochs", "preempt_sync_updates", "profile_steps", "model_axis"):
        parser.add_argument(f"--{name}", type=int, default=getattr(defaults, name))
    for name in ("stage1_lr", "stage2_lr1", "stage2_lr2", "ema_decay"):
        parser.add_argument(f"--{name}", type=float, default=getattr(defaults, name))
    parser.add_argument("--model_id", type=str, default=None)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16", choices=sorted(_DTYPES),
                        help="bfloat16 or float32 only (the JAX CLI takes any jnp dtype name)")
    parser.add_argument("--length_aware_loss", action="store_true")
    parser.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True,
                        help="recompute each encoder layer in the backward")
    parser.add_argument("--remat_policy", type=str, default="dots", choices=["full", "dots"])
    parser.add_argument("--bucket_boundaries", nargs="*", type=int, default=[],
                        help="bucketed training: sorted audio lengths (samples); each batch "
                             "pads to its bucket and the loss goes length-aware")
    for name in ("train_tfrecords", "val_tfrecords", "test_tfrecords"):
        parser.add_argument(f"--{name}", nargs="*", default=[])
    for name in ("train_dir", "val_dir", "test_dir", "wandb_project"):
        parser.add_argument(f"--{name}", type=str, default=None)
    parser.add_argument("--ckpt_dir", type=str, default="checkpoints")
    parser.add_argument("--log_dir", type=str, default="logs")
    parser.add_argument("--resume", type=str, default=None, metavar="RUN_DIR",
                        help="experiment dir of a previous run; each stage restores its "
                             "latest checkpoint and continues")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default: bf16 kernels, under torchrun the "
                             "card LOCAL_RANK modulo the cards) or cpu (f32 plain path)")
    return TrainingArgs(**vars(parser.parse_args(argv)))


def cli_main() -> None:
    main(parse_args())


if __name__ == "__main__":
    cli_main()
