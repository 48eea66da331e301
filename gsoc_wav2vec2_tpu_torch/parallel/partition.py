"""Tensor-parallel partitioning of wav2vec2 (counterpart of
`gsoc_wav2vec2_tpu/parallel/partition.py`).

The JAX package's rules, on the port's parameter names and its `Dense`
layout (kernel (in, out)):

  * ``q/k/v_proj`` and ``intermediate_dense``: kernels split by column,
    biases with them (attention heads, FFN units split over the model axis);
  * ``out_proj`` and ``output_dense``: kernels split by row, biases
    replicated (added once, after the partial products are summed);
  * everything else (conv front end, norms, positional conv, heads)
    replicated.

A spec is a tuple with one entry per dimension, `MODEL_AXIS` where the
dimension is split and None elsewhere; `()` is replicated (JAX's
`PartitionSpec`, without the layer-stack dimension: the port keeps its
layers in a `ModuleList`).

GSPMD inserts the model axis' collectives in JAX; here they are Megatron's
two conjugate autograd functions: `copy_to_model` at a column layer's input
(identity forward, all-reduce backward) and `reduce_from_model` after a row
layer's product (all-reduce forward, identity backward), so the replicated
parts of the network see the whole activations and get the same gradient on
every rank of a model group.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.basic import dense
from .mesh import MODEL_AXIS, Mesh, all_gather, all_reduce

Spec = Tuple[Optional[str], ...]

_COLUMN = {"q_proj", "k_proj", "v_proj", "intermediate_dense"}
_ROW = {"out_proj", "output_dense"}


def leaf_spec(name: str) -> Spec:
    """The spec of parameter `name` (a dotted state-dict name)."""
    parts = name.split(".")
    parent, leaf = (parts[-2], parts[-1]) if len(parts) >= 2 else (None, parts[-1])
    if parent in _COLUMN:
        if leaf == "kernel":
            return (None, MODEL_AXIS)
        if leaf == "bias":
            return (MODEL_AXIS,)
    if parent in _ROW and leaf == "kernel":
        return (MODEL_AXIS, None)
    return ()


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """Parameter name -> spec (tensor-parallel rules)."""
    return {name: leaf_spec(name) for name, _ in model.named_parameters()}


def _split_dim(spec: Spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_tensor(name: str, full: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's shard of the whole tensor `full` of parameter `name`."""
    dim = _split_dim(leaf_spec(name))
    if mesh is None or mesh.model == 1 or dim is None:
        return full
    n = full.shape[dim]
    if n % mesh.model:
        raise ValueError(f"{name}: dimension {dim} ({n}) does not divide the model axis "
                         f"({mesh.model})")
    size = n // mesh.model
    return full.narrow(dim, mesh.model_index * size, size).clone()


def shard_params(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Slice a whole model's split parameters to this rank's shards, in
    place (the Parameter objects stay, so build the optimizer after)."""
    if mesh is None or mesh.model == 1:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_tensor(name, p.data, mesh)
    return model


def shard_state_dict(state: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> dict:
    """Name -> whole tensor as name -> this rank's shard."""
    return {name: shard_tensor(name, t, mesh) for name, t in state.items()}


def unshard_tensor(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole tensor of parameter `name` from every model rank's shard
    (a collective over the model group)."""
    dim = _split_dim(leaf_spec(name))
    if mesh is None or mesh.model == 1 or dim is None:
        return t
    return torch.cat(all_gather(t, mesh.model_group), dim=dim)


def unshard_state_dict(state: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> dict:
    """Name -> shard as name -> whole tensor; every rank of the mesh calls it,
    in the same order."""
    return {name: unshard_tensor(name, t, mesh) for name, t in state.items()}


def is_sharded(name: str, mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.model > 1 and _split_dim(leaf_spec(name)) is not None


# ---------------------------------------------------------------------------
# Megatron's conjugate collectives
# ---------------------------------------------------------------------------


def _reduced(t: torch.Tensor, group) -> torch.Tensor:
    """The f32 sum of `t` over `group`, in `t`'s dtype."""
    return all_reduce(t.float().clone(), group).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """A sum over ranks whose backward is the sum of the ranks' cotangents:
    every rank's loss depends on every rank's inputs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A column layer's input: identity forward, all-reduce backward."""
    if mesh is None or mesh.model == 1:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def row_parallel_dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                       mesh: Optional[Mesh]) -> torch.Tensor:
    """`x @ kernel + bias` of a row-split layer: the partial products summed
    in f32 over the model group (identity backward), then the replicated
    bias added once, then cast to `x`'s dtype.  Without a model axis the plain
    `dense`."""
    if mesh is None or mesh.model == 1:
        return dense(x, kernel, bias)
    y = _ReduceFromModel.apply(dense(x, kernel, None).float(), mesh.model_group)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over `group` (backward: the summed cotangent)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)
