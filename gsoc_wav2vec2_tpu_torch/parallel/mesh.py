"""The ("data", "model") process mesh over `torch.distributed` (counterpart
of `gsoc_wav2vec2_tpu/parallel/mesh.py`).

One process drives one device, so the mesh is a grid of ranks laid out as the
JAX package lays out its devices, `reshape(data, model)` with the model axis
minor: rank = d * model + m, which is also the shard index JAX's
`shard_mapped_flash_attention` folds into the dropout seed.

  * ``data``  — the batch axis: each rank holds `global_batch / data` rows,
    and gradients are summed over the ranks of its data group (the ranks
    that share its model index);
  * ``model`` — the tensor-parallel axis: attention heads and FFN units are
    split over the ranks of its model group (those that share its data
    index; `partition.py`), which add their partial products together.

JAX's `shard_map_batch` has no counterpart: a rank's kernels only ever see
its local rows, as a `shard_map`ped Pallas call sees its shard.

The collectives below carry device tensors on the groups' backend, which
`multihost.initialize` fixes by rule: NCCL between cards, gloo where ranks
share a card (gloo takes CUDA tensors and stages them through the host
itself) and on the CPU.  Host-side control values go through
`multihost.all_gather_ints` instead.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) grid of `data * model` ranks and
    the two process groups it belongs to (None where the axis has size 1)."""

    data: int
    model: int
    rank: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shard_index(self) -> int:
        """The linear mesh index, d * model + m (JAX's flash shard index)."""
        return self.rank

    def row_span(self, local_rows: int) -> Tuple[int, int]:
        """(first global row, global rows) of this rank's `local_rows` batch rows."""
        return self.data_index * local_rows, self.data * local_rows

    def col_span(self, local_cols: int) -> Tuple[int, int]:
        """(first global column, global columns) of a column-split activation."""
        return self.model_index * local_cols, self.model * local_cols


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@functools.lru_cache(maxsize=None)
def _groups(data: int, model: int):
    """Every data group and every model group of the grid, created once per
    shape in one order on every rank (`new_group` is collective)."""
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    return data_groups, model_groups


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the process group's ranks (one process:
    a 1 x 1 mesh).  `data=-1` means the ranks the model axis leaves; the
    model axis must divide the world and `data * model` must equal it."""
    n, rank = _world()
    if model < 1 or n % model != 0:
        raise ValueError(f"model axis {model} does not divide device count {n}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if n == 1:
        return Mesh(1, 1, 0)
    data_groups, model_groups = _groups(data, model)
    return Mesh(data, model, rank,
                data_group=data_groups[rank % model] if data > 1 else None,
                model_group=model_groups[rank // model] if model > 1 else None)


def global_rows(mesh: Optional[Mesh], local_rows: int) -> Optional[Tuple[int, int]]:
    """(first global row, global rows) of a rank's batch, None in one process:
    the `rows` of the draws made over the whole batch (SpecAugment, Gumbel
    noise, negatives), which a rank takes its rows of."""
    if mesh is None or mesh.data == 1:
        return None
    return mesh.row_span(local_rows)


def global_span(mesh: Optional[Mesh], shape, split_last: bool = False):
    """Where a rank's (B, ..., C) activation lies in the one-process tensor,
    as `(offsets, full_shape)` (`ops.basic._element_index`): its rows of the
    batch and, with `split_last` (a column-split FFN activation), its
    columns.  None when the rank holds the whole tensor."""
    if mesh is None or mesh.size == 1 or (mesh.data == 1 and not split_last):
        return None
    shape = tuple(shape)
    r0, rows = mesh.row_span(shape[0])
    c0, cols = mesh.col_span(shape[-1]) if split_last else (0, shape[-1])
    middle = shape[1:-1]
    return (r0,) + (0,) * len(middle) + (c0,), (rows,) + middle + (cols,)


def batch_sharding(mesh: Optional[Mesh], global_batch: int) -> slice:
    """This rank's rows of a `global_batch`-row batch split over the data axis."""
    if mesh is None:
        return slice(0, global_batch)
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} does not divide the data axis "
                         f"({mesh.data})")
    b = global_batch // mesh.data
    start, _ = mesh.row_span(b)
    return slice(start, start + b)


def replicated(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """`tensor`, after checking that every rank of the mesh holds the same
    values (the sum of |x - x_max| over ranks is 0); raises otherwise."""
    if mesh is None or mesh.size == 1:
        return tensor
    hi = all_reduce(tensor.detach().float().clone(), None, op=dist.ReduceOp.MAX)
    diff = all_reduce((hi - tensor.detach().float()).abs().sum().reshape(1), None)
    if float(diff) != 0.0:
        raise ValueError("a tensor that must be replicated differs across ranks")
    return tensor


# ---------------------------------------------------------------------------
# Collectives of device tensors
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (None: the whole world); returns `t`."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (same shape on all), in group-rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts
