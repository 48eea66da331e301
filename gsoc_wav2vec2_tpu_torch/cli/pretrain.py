"""Pretraining command-line program, in part (counterpart of `gsoc_wav2vec2_tpu/cli/pretrain.py`).

What is here is what exists without a data plane: the hyper-parameters
(`PretrainingArgs`), the Gumbel temperature anneal (`gumbel_temperature`) and
the per-batch span masks (`batch_masks`).  With `training.pretrain_lr_schedule`,
`training.create_pretrain_optimizer` and `models.pretraining.make_pretrain_step`
they are one update of the loop:

    set_learning_rate(state.optimizer, schedule(state.step))
    batch["mask_time_indices"] = batch_masks(generator, batch["attention_mask"], config, args)
    state, metrics = step(state, batch, generator, gumbel_temperature(args, state.step))

`main` / `parse_args` (the epoch loop over a LibriSpeech loader, checkpoints,
resume, metric logging, the fine-tune-ready export) wait for the port's data
loaders, `CheckpointManager`, `MetricLogger` and `save_pretrained`; there is
no console script yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import Wav2Vec2PretrainingConfig
from ..ops.specaugment import compute_mask_indices


@dataclass
class PretrainingArgs:
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
    # EMA shadow weights (0 = off)
    ema_decay: float = 0.0
    audio_maxlen: int = 246000
    # LR-decay horizon; 0 = the paper recipe's 500k steps
    total_steps: int = 0
    seed: int = 0


def gumbel_temperature(args: PretrainingArgs, step: int) -> float:
    return max(args.gumbel_temp_max * args.gumbel_temp_decay**step, args.gumbel_temp_min)


def batch_masks(generator: torch.Generator, attention_mask: torch.Tensor,
                config: Wav2Vec2PretrainingConfig, args: PretrainingArgs) -> torch.Tensor:
    """Bool (B, frames) span mask for one batch, restricted to real frames:
    padded frames must never become contrastive targets or negatives (an
    utterance padded to `audio_maxlen` is often 20-70% padding).  On the
    attention mask's device."""
    attention_mask = torch.as_tensor(attention_mask)
    b, samples = attention_mask.shape
    frames = int(config.conv_output_length(samples))
    frame_length = config.conv_output_length(attention_mask.to(torch.int64).sum(dim=-1))
    mask = compute_mask_indices(generator, b, frames, args.mask_time_prob, args.mask_time_length)
    valid = torch.arange(frames, device=attention_mask.device)[None, :] < frame_length[:, None]
    return mask.to(attention_mask.device) & valid
