"""The serving artifact: the eval forward as a `torch.export` program.

Counterpart of `gsoc_wav2vec2_tpu/export/stablehlo.py` (a `jax.export`
artifact) and of the reference's fixed-shape TFHub SavedModel
(`src/export2hub.py`).  The forward is traced once on the model's device at
a fixed number of samples, with a symbolic batch by default, and written as
`model.pt2` (`torch.export.save`) beside `export_meta.json` and
`config.json`.  Dropout and SpecAugment are off (the eval forward), as
`export2hub.py:63-69` exports with `apply_spec_augment=False`.

The kernels stay in the graph: the sites call the front ends, the
positional conv and attention as `torch.library` operators
(`w2v2::fused_conv01`, `w2v2::fused_conv01_robust`, `w2v2::pos_conv`,
`w2v2::flash_attention_fwd`, registered by `ops/kernels`), which tracing
keeps as opaque calls, so an artifact exported on the card launches the
same kernels as the live model, as the JAX artifact lowered on a TPU keeps
its Pallas calls.  Loading needs `ops/kernels` only, not the model code.
Like the JAX artifact, one is made for one platform: an artifact exported
for CUDA does not load for the CPU, nor the other way round.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import kernels as _kernels  # noqa: F401  (registers the operators the program calls)
from ..utils.devices import resolve_device

ARTIFACT_NAME = "model.pt2"
META_NAME = "export_meta.json"


class _EvalForward(nn.Module):
    """The eval forward of `model` in `compute_dtype`: the module that
    `torch.export` traces (its parameters become the program's)."""

    def __init__(self, model: nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, speech: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        return type(self.model)._forward(self.model, self.model.config, speech, attention_mask,
                                         compute_dtype=self.compute_dtype)


def export_model(
    model: nn.Module,
    save_dir: str,
    *,
    seqlen: int = 246000,
    batch_size: Optional[int] = None,
    with_lm_head: bool = True,
    with_attention_mask: Optional[bool] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> str:
    """Export the eval forward of `model` (a `Wav2Vec2ForCTC`, or the bare
    `Wav2Vec2Model` with `with_lm_head=False`; a CTC model then exports its
    backbone) on the model's device; returns the path of `model.pt2`.

    `batch_size=None` gives a symbolic batch (`torch.export.Dim`): one
    artifact runs any batch.  Robust models take `(speech, attention_mask)`,
    both (batch, seqlen) f32, as in `export2hub.py:40-57`."""
    config = model.config
    if with_lm_head and not model._with_lm_head:
        raise ValueError("with_lm_head=True needs a Wav2Vec2ForCTC")
    target = model.wav2vec2 if (model._with_lm_head and not with_lm_head) else model
    if with_attention_mask is None:
        with_attention_mask = config.is_robust
    dev = model.device
    example = batch_size or 2
    args = (torch.zeros((example, seqlen), device=dev),)
    if with_attention_mask:
        args += (torch.ones((example, seqlen), device=dev),)
    dynamic_shapes = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1)
        dynamic_shapes = tuple({0: batch} for _ in args)
    program = torch.export.export(_EvalForward(target, compute_dtype).eval(), args,
                                  dynamic_shapes=dynamic_shapes)

    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, ARTIFACT_NAME)
    torch.export.save(program, path)
    with open(os.path.join(save_dir, META_NAME), "w") as f:
        json.dump(
            {
                "seqlen": seqlen,
                "batch_size": batch_size,
                "with_lm_head": with_lm_head,
                "with_attention_mask": with_attention_mask,
                "compute_dtype": str(compute_dtype).removeprefix("torch."),
                "vocab_size": config.vocab_size,
                "device": dev.type,
            },
            f,
        )
    config.save_pretrained(save_dir)
    return path


def load_exported(save_dir: str, device=None) -> Tuple[torch.export.ExportedProgram, dict]:
    """(program, meta) of an `export_model` directory, for `device` (None:
    CUDA, as every entry point).  `program.module()(speech[, mask])` runs
    it.  Raises `ValueError` when the artifact was exported for another
    device type."""
    dev = resolve_device(device)
    with open(os.path.join(save_dir, META_NAME)) as f:
        meta = json.load(f)
    if meta["device"] != dev.type:
        raise ValueError(
            f"{save_dir} was exported for {meta['device']}, not {dev.type}: an artifact runs "
            f"on the device type it was exported on; export it again with --device {dev.type}"
        )
    return torch.export.load(os.path.join(save_dir, ARTIFACT_NAME)), meta
