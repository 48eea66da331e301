"""SpecAugment time masking (counterpart of `gsoc_wav2vec2_tpu/ops/specaugment.py`).

Same semantics as the JAX module, with an explicit `torch.Generator` where
JAX threads keys (the two draw different numbers from one seed):

* `num_mask_spans = int(mask_prob * seqlen / mask_length + U[0, 1))` per
  sample, clamped to `[min_masks, seqlen // mask_length]` and to a static
  upper bound;
* span starts drawn without replacement from `[0, seqlen - mask_length]` by
  the Gumbel-top-k trick;
* masked frames take the trainable `masked_spec_embed` vector; feature
  masking zeroes spans of the hidden axis, shared across time.

The random numbers are drawn on the generator's device (the CPU by default)
and the mask is moved to the features' device.
"""

from __future__ import annotations

import torch


def compute_mask_indices(
    generator: torch.Generator, batch_size: int, seqlen: int, mask_prob: float,
    mask_length: int, min_masks: int = 2,
) -> torch.Tensor:
    """Bool (batch_size, seqlen) mask of frames to replace."""
    if mask_length > seqlen:
        raise ValueError(
            f"`mask_length` ({mask_length}) must be smaller than `seq_length` ({seqlen})."
        )
    base = mask_prob * seqlen / mask_length
    max_spans = min(max(int(base) + 1, min_masks), seqlen // mask_length)

    frac = torch.rand(batch_size, generator=generator)
    num_spans = torch.floor(base + frac).to(torch.int64)
    num_spans = num_spans.clamp(min_masks, seqlen // mask_length).clamp(max=max_spans)

    # Gumbel-top-k: max_spans distinct starts in [0, seqlen - mask_length]
    u = torch.rand(batch_size, seqlen - (mask_length - 1), generator=generator)
    z = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    starts = torch.topk(z, max_spans, dim=-1).indices  # (B, S)
    span_valid = torch.arange(max_spans)[None, :] < num_spans[:, None]

    frames = torch.arange(seqlen)[None, None, :]
    starts = starts[:, :, None]
    in_span = (frames >= starts) & (frames < starts + mask_length) & span_valid[:, :, None]
    return in_span.any(dim=1)


def _rows_of(generator, b, seqlen, mask_prob, mask_length, min_masks, rows):
    """`b` rows of the mask: all of a batch of `b`, or with `rows = (start,
    global_rows)` rows [start, start + b) of the global batch's mask (a
    data-parallel rank's share of the one-process draw)."""
    if rows is None:
        return compute_mask_indices(generator, b, seqlen, mask_prob, mask_length, min_masks)
    start, total = rows
    full = compute_mask_indices(generator, total, seqlen, mask_prob, mask_length, min_masks)
    return full[start:start + b]


def apply_spec_augmentation(
    generator: torch.Generator, features: torch.Tensor, masked_spec_embed: torch.Tensor,
    mask_prob: float, mask_length: int, min_masks: int = 2, rows=None,
) -> torch.Tensor:
    """Replace randomly chosen time spans with the mask embedding (`rows` as
    in `_rows_of`)."""
    b, l, _ = features.shape
    mask = _rows_of(generator, b, l, mask_prob, mask_length, min_masks, rows)
    fill = masked_spec_embed.to(features.dtype)[None, None, :]
    return torch.where(mask.to(features.device)[:, :, None], fill, features)


def apply_feature_masking(
    generator: torch.Generator, features: torch.Tensor, mask_prob: float,
    mask_length: int, min_masks: int = 0, rows=None,
) -> torch.Tensor:
    """Zero random spans of the hidden axis, shared across all time steps of
    a sample (HF `mask_feature_prob`; the fill is 0, not the embedding;
    `rows` as in `_rows_of`)."""
    b, _, h = features.shape
    mask = _rows_of(generator, b, h, mask_prob, mask_length, min_masks, rows)
    return features * (~mask).to(features.device, features.dtype)[:, None, :]
