"""Train state, optimizer recipes (CTC fine-tuning, pretraining), train / eval steps."""

from .determinism import deterministic_training
from .state import (
    TrainState,
    create_optimizer,
    create_pretrain_optimizer,
    create_train_state,
    get_learning_rate,
    pretrain_lr_schedule,
    set_learning_rate,
    set_trainable,
    stage2_lr_schedule,
    trainable_mask,
)
from .trainer import (
    ema_update,
    global_norm,
    make_ctc_loss_fn,
    make_eval_step,
    make_grad_accum_steps,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_optimizer",
    "create_pretrain_optimizer",
    "create_train_state",
    "deterministic_training",
    "get_learning_rate",
    "pretrain_lr_schedule",
    "set_learning_rate",
    "set_trainable",
    "stage2_lr_schedule",
    "trainable_mask",
    "ema_update",
    "global_norm",
    "make_ctc_loss_fn",
    "make_eval_step",
    "make_grad_accum_steps",
    "make_train_step",
]
