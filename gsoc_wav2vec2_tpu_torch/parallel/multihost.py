"""Multi-process bootstrap and lockstep helpers (counterpart of
`gsoc_wav2vec2_tpu/parallel/multihost.py`).

JAX runs one process per host over all of its devices; the port runs one
process per device, started by `torchrun` (or any launcher that sets its
environment):

    torchrun --nproc_per_node 8 -m gsoc_wav2vec2_tpu_torch.cli.train \\
        --model_axis 2 --train_dir ...

`initialize` reads `MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`,
`LOCAL_RANK` and `LOCAL_WORLD_SIZE`; with one process it does nothing.
Every helper is an identity in a one-process run.  Each rank feeds its own
rows: the loaders shard by the rank's data index (`data/loaders.py`), and
the helpers below keep the ranks' streams in step, since a rank that enters
a collective alone waits until the group's timeout.

The backend is a rule, not a choice and not a fallback (`backend_for`):
device tensors go over NCCL when every rank of a host owns a card of its
own, over gloo when ranks share a card (NCCL refuses two ranks on one
device: `ncclInvalidUsage`, "Duplicate GPU detected") and on the CPU.
Control values (counts, flags, run ids, WER sums) are small host tensors
and always go through a gloo group (`control_group`), as JAX's
`process_allgather` works on host numpy.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.devices import rank_device
from .mesh import DATA_AXIS, Mesh, batch_sharding

# the gloo group of every rank that carries the host-side control values
# when the default group is NCCL (None: the default group is gloo)
_control = None
# the timeout `initialize` gave the group (the default until a group is joined)
DEFAULT_TIMEOUT_S = 1800.0
_timeout_s = DEFAULT_TIMEOUT_S


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def backend_for(device: torch.device) -> str:
    """"nccl" for a CUDA rank whose host has a card for each of its ranks
    (`LOCAL_WORLD_SIZE`, else `WORLD_SIZE`, at most `cuda.device_count()`),
    "gloo" where ranks share a card, and on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[str]:
    """Join the process group that torchrun's environment describes, on
    `rank_device(device)` with `backend_for` that device, and print the
    backend; returns it (None for one process, where there is nothing to
    join).  Idempotent: a later call keeps the first call's group and
    timeout.  `timeout_s` bounds every collective, so a rank whose peer died
    fails instead of waiting forever (`group_timeout_s`)."""
    global _control, _timeout_s
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _timeout_s = float(timeout_s)
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), timeout=timeout)
    if backend != "gloo":
        _control = dist.new_group(backend="gloo", timeout=timeout)
    print(f"distributed: rank {dist.get_rank()} of {dist.get_world_size()}, backend {backend}, "
          f"device {dev}", flush=True)
    return backend


def group_timeout_s() -> float:
    """The seconds a collective of the joined group may wait (`initialize`'s
    `timeout_s`)."""
    return _timeout_s


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _control, _timeout_s
    if dist.is_initialized():
        from .mesh import _groups

        _groups.cache_clear()
        _control = None
        _timeout_s = DEFAULT_TIMEOUT_S
        dist.destroy_process_group()


def all_gather_ints(values) -> torch.Tensor:
    """(ranks, n) int64 on the host: every rank's `values` (n ints), over
    the control group."""
    t = torch.as_tensor(values, dtype=torch.int64).reshape(-1)
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t, group=_control)
    return torch.stack(parts)


def broadcast_from_leader(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's host tensor `t` into every rank's `t` (in place, the same
    shape and dtype on all), over the control group; returns `t`."""
    dist.broadcast(t, src=0, group=_control)
    return t


def gather_to_leader(t: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """Every rank's host tensor `t` (the same shape on all) on rank 0, in
    rank order, over the control group; None on the other ranks."""
    parts = [torch.empty_like(t) for _ in range(world_size())] if rank() == 0 else None
    dist.gather(t, parts, dst=0, group=_control)
    return parts


def sync_run_id(run_id: str, max_len: int = 64) -> str:
    """Every process adopts process 0's run id (checkpoint dirs must agree)."""
    if world_size() == 1:
        return run_id
    raw = list(run_id.encode()[:max_len])
    buf = raw + [0] * (max_len - len(raw))
    synced = all_gather_ints(buf)[0]
    return bytes(int(c) for c in synced).rstrip(b"\x00").decode()


def sync_min_count(count: Optional[int]) -> Optional[int]:
    """Global minimum of a per-process count (one all-gather); None stays
    None.  For what must be identical on every rank but comes from its own
    data shard, such as an LR schedule's horizon."""
    if count is None or world_size() == 1:
        return count
    return int(all_gather_ints([int(count)]).min())


def lockstep_batches(iterator, num_batches: Optional[int] = None):
    """Yield from this rank's batch iterator while every rank still has a
    batch.  With `num_batches` known, one all-gather of the counts and then
    `min(counts)` batches with no further collectives (a shortfall raises
    StopIteration's RuntimeError); otherwise a have-a-batch flag all-gathered
    each step."""
    if world_size() == 1:
        yield from iterator
        return
    it = iter(iterator)
    if num_batches is not None:
        for _ in range(int(all_gather_ints([int(num_batches)]).min())):
            yield next(it)
        return
    while True:
        try:
            batch, have = next(it), 1
        except StopIteration:
            batch, have = None, 0
        if int(all_gather_ints([have]).min()) == 0:
            return
        yield batch


def lockstep_bucket_batches(iterator, repad):
    """Lockstep a bucketed batch stream: each step one all-gather of
    (have_batch, audio_len); every rank brings its batch to the longest
    audio length with `repad` (the loaders' `repad_batch`); the stream stops
    when any rank runs dry."""
    if world_size() == 1:
        yield from iterator
        return
    it = iter(iterator)
    while True:
        try:
            batch = next(it)
            have, blen = 1, int(batch["speech"].shape[1])
        except StopIteration:
            batch, have, blen = None, 0, 0
        info = all_gather_ints([have, blen])
        if int(info[:, 0].min()) == 0:
            return
        yield repad(batch, int(info[:, 1].max()))


def host_local_batch_to_global(batch, mesh: Mesh, global_batch: Optional[int] = None):
    """The rows a rank computes on are the rows it loaded: returns `batch`,
    after checking that the global batch (`global_batch`, else local rows x
    data axis) divides the data axis into this rank's row count."""
    rows = len(next(iter(batch.values()))) if isinstance(batch, dict) else len(batch)
    total = rows * mesh.shape[DATA_AXIS] if global_batch is None else global_batch
    span = batch_sharding(mesh, total)
    if span.stop - span.start != rows:
        raise ValueError(f"{rows} local rows, but a global batch of {total} gives each of "
                         f"{mesh.data} data ranks {span.stop - span.start}")
    return batch


def max_flag(flag: bool) -> bool:
    """True when any rank's `flag` is (one all-gather)."""
    if world_size() == 1:
        return bool(flag)
    return bool(all_gather_ints([int(bool(flag))]).max())


def sum_counts(values) -> np.ndarray:
    """The element-wise sum over ranks of int `values` (one all-gather)."""
    if world_size() == 1:
        return np.asarray(values, np.int64)
    return all_gather_ints(values).sum(dim=0).numpy()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
