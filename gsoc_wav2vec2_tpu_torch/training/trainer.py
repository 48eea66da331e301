"""Train and eval steps (counterpart of `gsoc_wav2vec2_tpu/training/trainer.py`).

JAX compiles forward, CTC loss, backward and the Adam update into one `jit`
with donated state.  PyTorch runs them eagerly; the step updates the model's
parameters and the optimizer's state in place (the counterpart of the
donation), and returns the same `TrainState` object.  The loss is JAX's:
SUM of per-sample CTC losses over the batch divided by `division_factor`
(the global batch size, reference `main.py:196-200`), with either the
reference's constant logit length or the `length_aware` one.

`batch` is a dict with "speech" (B, L) float, "labels" (B, U) int, pad-padded,
and optionally "attention_mask" (B, L); tensors or numpy arrays, moved to the
model's device.  Randomness (dropout, SpecAugment, stochastic depth) comes
from the `torch.Generator` the caller passes to each step.

Under a `mesh` (`parallel.Mesh`; JAX's `mesh=` of `make_train_step`) each
rank passes its rows of the global batch and a generator in the same state
as every other rank's; the model holds this rank's shards
(`parallel.shard_params`).  After the backward the gradients are summed
over the data group, one bucket a dtype, so with `division_factor` the global
batch the update is the one-process update (a mean, as DDP's default, would
make it `data` times too small); each rank's Adam then updates its shards.
The metrics are the global ones: the loss summed over the data group,
`grad_norm` over whole tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

import torch

from ..models.config import Wav2Vec2Config
from ..models.modeling import default_compute_dtype, wav2vec2_for_ctc_forward
from ..ops.ctc import ctc_loss_fn
from ..parallel.mesh import Mesh, all_reduce
from ..parallel.partition import is_sharded
from .state import TrainState


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def grad_norm(model, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`global_norm` of the trainable parameters' gradients, over whole
    tensors: a sharded parameter's squares summed over the model group, a
    replicated one's counted once."""
    named = [(n, p.grad) for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None]
    if mesh is None or mesh.model == 1:
        return global_norm(g for _, g in named)
    zero = torch.zeros((), device=model.device)
    squares = [torch.sum(g.float() ** 2) for _, g in named]
    sharded = sum((s for (n, _), s in zip(named, squares) if is_sharded(n, mesh)), zero)
    whole = sum((s for (n, _), s in zip(named, squares) if not is_sharded(n, mesh)), zero)
    return torch.sqrt(whole + all_reduce(sharded.clone(), mesh.model_group))


def all_reduce_grads(model, mesh: Optional[Mesh]) -> None:
    """Sum the trainable parameters' gradients over the data group, in
    place: one flat bucket per (device, dtype)."""
    if mesh is None or mesh.data == 1:
        return
    buckets: dict = {}
    for p in model.parameters():
        if p.requires_grad and p.grad is not None:
            buckets.setdefault((p.grad.device, p.grad.dtype), []).append(p.grad)
    for grads in buckets.values():
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh.data_group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def data_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A per-rank metric summed over the data group (a copy)."""
    if mesh is None or mesh.data == 1:
        return t
    return all_reduce(t.detach().clone(), mesh.data_group)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_ctc_loss_fn(config: Wav2Vec2Config, *, division_factor: float,
                     with_attention_mask: bool = False, length_aware: bool = False,
                     compute_dtype: Optional[torch.dtype] = None,
                     remat: Union[bool, str] = True, mesh: Optional[Mesh] = None):
    """`(model, batch, generator) -> scalar loss` of the training forward
    (JAX `_make_ctc_loss_fn`).  What is frozen is what has `requires_grad`
    off (`set_trainable`).  `remat` as `modeling.encoder_forward`'s (JAX's
    step functions default to True).  Under a `mesh` the loss of this rank's
    rows: the global loss is its sum over the data group."""

    def loss_fn(model, batch: dict, generator: torch.Generator) -> torch.Tensor:
        dev = model.device
        batch = _to_device(batch, dev)
        mask = batch.get("attention_mask") if with_attention_mask else None
        logits = wav2vec2_for_ctc_forward(
            model, config, batch["speech"].float(), mask,
            compute_dtype=compute_dtype or default_compute_dtype(dev),
            training=True, generator=generator, remat=remat, mesh=mesh,
        )
        b, t = logits.shape[0], logits.shape[1]
        if length_aware and mask is not None:
            logit_lengths = config.conv_output_length(mask.to(torch.int64).sum(dim=-1))
        else:
            # the reference's constant logit length, padding frames included
            logit_lengths = torch.full((b,), t, dtype=torch.int64)
        per_sample = ctc_loss_fn(logits, batch["labels"], logit_lengths, config.pad_id)
        return per_sample.sum() / division_factor

    return loss_fn


def ema_update(ema_params: Dict[str, torch.Tensor], model, decay: float) -> None:
    """In place, `ema <- ema * decay + params * (1 - decay)` (no bias
    correction: the shadow starts at the initial parameters)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            e = ema_params[name]
            e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))


def _trainable(model):
    return [p for p in model.parameters() if p.requires_grad]


def _apply(state: TrainState, loss: torch.Tensor, ema_decay: Optional[float],
           mesh: Optional[Mesh] = None):
    all_reduce_grads(state.model, mesh)
    metrics = {"loss": data_sum(loss.detach(), mesh), "grad_norm": grad_norm(state.model, mesh)}
    state.optimizer.step()
    if ema_decay is not None:
        ema_update(state.ema_params, state.model, ema_decay)
    state.step += 1
    return state, metrics


def make_train_step(config: Wav2Vec2Config, *, division_factor: float,
                    with_attention_mask: bool = False, length_aware: bool = False,
                    compute_dtype: Optional[torch.dtype] = None,
                    ema_decay: Optional[float] = None, remat: Union[bool, str] = True,
                    mesh: Optional[Mesh] = None):
    """`(state, batch, generator) -> (state, {"loss", "grad_norm"})`: one
    forward, backward and Adam update, in place, of the parameters that
    `set_trainable` left trainable.  With `ema_decay` the state must carry
    `ema_params`; `remat` as in `make_ctc_loss_fn`; `mesh` as in the module
    docstring (`division_factor` is then the global batch)."""
    loss_fn = make_ctc_loss_fn(config, division_factor=division_factor,
                               with_attention_mask=with_attention_mask,
                               length_aware=length_aware, compute_dtype=compute_dtype,
                               remat=remat, mesh=mesh)

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch, generator)
        loss.backward()
        return _apply(state, loss, ema_decay, mesh)

    return step


def make_grad_accum_steps(config: Wav2Vec2Config, *, division_factor: float,
                          with_attention_mask: bool = False, length_aware: bool = False,
                          compute_dtype: Optional[torch.dtype] = None,
                          ema_decay: Optional[float] = None, remat: Union[bool, str] = True,
                          mesh: Optional[Mesh] = None):
    """Gradient accumulation, `(init_fn, accum_fn, apply_fn)`: microbatch
    gradients sum in the parameters' `.grad`, so with `division_factor` the
    effective batch size the update equals one step on the whole batch
    (under a `mesh` the gradients are summed over the data group once, in
    `apply_fn`)::

        loss = init_fn(state)
        for batch in microbatches:
            loss = accum_fn(state, batch, generator, loss)
        state, metrics = apply_fn(state, loss)
    """
    loss_fn = make_ctc_loss_fn(config, division_factor=division_factor,
                               with_attention_mask=with_attention_mask,
                               length_aware=length_aware, compute_dtype=compute_dtype,
                               remat=remat, mesh=mesh)

    def init_fn(state: TrainState) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        return torch.zeros((), dtype=torch.float32)

    def accum_fn(state: TrainState, batch: dict, generator: torch.Generator,
                 loss_acc: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(state.model, batch, generator)
        loss.backward()
        return loss_acc + loss.detach().cpu()

    def apply_fn(state: TrainState, loss_acc: torch.Tensor):
        return _apply(state, loss_acc, ema_decay, mesh)

    return init_fn, accum_fn, apply_fn


def make_eval_step(config: Wav2Vec2Config, *, with_attention_mask: bool = False,
                   compute_dtype: Optional[torch.dtype] = None):
    """`(model, batch) -> (greedy_ids (B, T) int32, frame_lengths (B,) int32)`
    for WER evaluation; the CTC collapse stays on the host."""

    def eval_step(model, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = model.device
        batch = _to_device(batch, dev)
        mask = batch.get("attention_mask") if with_attention_mask else None
        with torch.inference_mode():
            logits = wav2vec2_for_ctc_forward(
                model, config, batch["speech"].float(), mask,
                compute_dtype=compute_dtype or default_compute_dtype(dev))
        predictions = logits.argmax(dim=-1).to(torch.int32)
        if mask is not None:
            lengths = config.conv_output_length(mask.to(torch.int64).sum(dim=-1))
        else:
            lengths = torch.full((logits.shape[0],), logits.shape[1], dtype=torch.int64)
        return predictions, lengths.to(torch.int32)

    return eval_step
