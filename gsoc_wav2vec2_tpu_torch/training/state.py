"""Train state and optimizer recipe (counterpart of
`gsoc_wav2vec2_tpu/training/state.py`).

The recipe trains in two stages (reference `main.py:204-255`):

  stage 1: backbone frozen (`set_trainable(model, ("wav2vec2",))`), Adam
           1e-3, trains only the LM head;
  stage 2: everything but the conv feature extractor
           (`set_trainable(model, ("feature_extractor",))`), Adam 1e-4
           dropping to 5e-5 after epoch 10.

JAX masks the frozen leaves out of the optimizer (`optax.multi_transform`
with `set_to_zero`); here they have `requires_grad` off and the Adam holds
only the trainable parameters, so frozen leaves get no gradient, no state
and no update.

Pretraining trains every parameter with AdamW under a warmup -> linear-decay
schedule (`create_pretrain_optimizer`, `pretrain_lr_schedule`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    """The model (its parameters updated in place by the step), its Adam,
    the step count, the optional EMA shadow weights (name -> tensor) and the
    generator the step draws its randomness from (kept here so that a
    checkpoint carries its state)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    generator: Optional[torch.Generator] = None


def trainable_mask(model: nn.Module, frozen_subtrees=()) -> Dict[str, bool]:
    """Parameter name -> trainable: False for every name with a component
    (between dots) in `frozen_subtrees`, as JAX's key-path match, e.g.
    ("feature_extractor",) freezes the conv stack and ("wav2vec2",) the
    whole backbone (stage 1)."""
    frozen = set(frozen_subtrees)
    return {n: not frozen.intersection(n.split(".")) for n, _ in model.named_parameters()}


def set_trainable(model: nn.Module, frozen_subtrees=()) -> Dict[str, bool]:
    """Turn `requires_grad` on for exactly the trainable parameters of
    `trainable_mask`; returns the mask."""
    mask = trainable_mask(model, frozen_subtrees)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return mask


def stage2_lr_schedule(lr1: float = 1e-4, lr2: float = 5e-5,
                       transition_step: int = 0) -> Callable[[int], float]:
    """Step -> learning rate: lr1 before `transition_step`, lr2 from it on
    (JAX: `optax.join_schedules` of two constants)."""
    return lambda step: lr1 if step < transition_step else lr2


def create_optimizer(model: nn.Module, learning_rate: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps outside
    the square root, bias-corrected) over the parameters that require
    gradients, in `named_parameters` order."""
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("no parameter requires a gradient: call set_trainable first")
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def pretrain_lr_schedule(lr: float, warmup_steps: int,
                         total_steps: int) -> Callable[[int], float]:
    """Update count -> learning rate: linear warmup from 0 to `lr` over
    `warmup_steps`, then linear decay to 0 at `total_steps` (JAX:
    `optax.join_schedules` of two `linear_schedule`s).  optax counts from 0,
    so the first update runs at learning rate 0: call it with `state.step`
    before each step."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warm:
            return lr * min(max(count / warm, 0.0), 1.0)
        return lr * (1.0 - min((count - warm) / decay, 1.0))

    return schedule


def create_pretrain_optimizer(model: nn.Module, learning_rate: float, *,
                              weight_decay: float = 0.01,
                              eps: float = 1e-6) -> torch.optim.AdamW:
    """The pretraining optimizer: AdamW (b1 0.9, b2 0.999, decoupled decay)
    over every parameter that requires a gradient, biases and norms included,
    as `optax.adamw` decays every leaf."""
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("no parameter requires a gradient: call set_trainable first")
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=eps,
                             weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every param group's learning rate (JAX: the injected
    hyperparameter of `inject_hyperparams`)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return optimizer.param_groups[0]["lr"]


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       ema: bool = False,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """A state at step 0; `ema=True` starts the shadow weights at a copy of
    the current parameters."""
    ema_params = None
    if ema:
        ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, ema_params=ema_params,
                      generator=generator)
