"""CTC loss (counterpart of `gsoc_wav2vec2_tpu/ops/ctc.py`).

`log_softmax(logits)` in f32, then `ops/kernels/ctc.py::ctc_loss`, per
sample, blank = pad id: optax's recursion (`optax.ctc_loss`, which the JAX
package calls), with its log 0 of -1e5, so a row whose labels cannot fit its
frames has a large finite loss and gradient as in JAX.  On the card it runs
the deterministic CUDA kernels (more than `MAX_LABELS` label positions a
row raise there); on the CPU the plain loop.  Both semantics of the JAX
module are kept:

* the reference's constant logit length: the conv stack's output length of
  the padded input, padding frames included (`ops/ctc.py:10-12`);
* `length_aware`: logit lengths from the sample-level attention mask.

Label length is the number of non-pad ids (labels are pad-padded at the
end); the batch loss is the SUM of per-sample losses / `division_factor`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import ctc as ctc_kernel


def ctc_loss_fn(
    logits: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor, pad_id: int = 0,
) -> torch.Tensor:
    """(B, T, V) unnormalised logits, (B, U) pad-padded labels, (B,) valid
    frame counts -> (B,) per-sample negative log-likelihood (f32)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(labels).to(logits.device)
    logit_lengths = torch.as_tensor(logit_lengths, dtype=torch.int64).to(logits.device)
    return ctc_kernel.ctc_loss(log_probs, labels, logit_lengths, pad_id)


class CTCLoss:
    """The reference `CTCLoss`: `model_input_shape` is (batch_size,
    audio_len); the constant logit length is the conv stack's output length
    of `audio_len`."""

    def __init__(self, config, model_input_shape, division_factor: int = 1,
                 length_aware: bool = False):
        self.config = config
        self.pad_id = config.pad_id
        self.division_factor = division_factor
        self.model_input_shape = tuple(model_input_shape)
        self.length_aware = length_aware
        self._const_logit_length = int(config.conv_output_length(self.model_input_shape[1]))

    def __call__(self, labels: torch.Tensor, logits: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """SUM of per-sample CTC losses / division_factor."""
        b = logits.shape[0]
        if self.length_aware and attention_mask is not None:
            sample_lengths = attention_mask.to(torch.int64).sum(dim=-1)
            logit_lengths = self.config.conv_output_length(sample_lengths)
        else:
            logit_lengths = torch.full((b,), self._const_logit_length, dtype=torch.int64)
        per_sample = ctc_loss_fn(logits, labels, logit_lengths, self.pad_id)
        return per_sample.sum() / self.division_factor
