"""Data and tensor parallelism over `torch.distributed` (counterpart of
`gsoc_wav2vec2_tpu/parallel/`): the (data, model) process mesh, the
tensor-parallel partition rules and the multi-process helpers."""

from . import multihost
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, batch_sharding, make_mesh, replicated
from .partition import param_specs, shard_params, unshard_state_dict

__all__ = [
    "multihost",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "param_specs",
    "shard_params",
    "unshard_state_dict",
]
