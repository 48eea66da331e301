"""Multi-head self-attention (counterpart of `gsoc_wav2vec2_tpu/ops/attention.py`).

Separate q/k/v/out projections, q scaled by `head_size ** -0.5`, an additive
key bias on the raw scores, softmax in float32 and probabilities cast to the
compute dtype before the product with v.  `mha` runs the core through
`ops/kernels/flash_attention.py`: the hand-written kernel for a CUDA tensor,
its plain version on the CPU.  `mha_plain` is the full-materialisation
formulation (the counterpart of JAX's `mha_xla`) the tests hold it against.
"""

from __future__ import annotations

from typing import Optional

import torch

from .basic import dense
from .kernels import flash_attention as flash


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H) -> (B, num_heads, L, head_size)."""
    b, l, h = x.shape
    return x.reshape(b, l, num_heads, h // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, num_heads, L, head_size) -> (B, L, H)."""
    b, n, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, n * d)


def _project_qkv(x, params, num_heads):
    head_size = x.shape[-1] // num_heads
    q = split_heads(dense(x, params.q_proj.kernel, params.q_proj.bias), num_heads)
    k = split_heads(dense(x, params.k_proj.kernel, params.k_proj.bias), num_heads)
    v = split_heads(dense(x, params.v_proj.kernel, params.v_proj.bias), num_heads)
    return q * head_size ** -0.5, k, v


def mha_plain(
    x: torch.Tensor, params, num_heads: int, mask_bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Full-materialisation attention (counterpart of `mha_xla`).

    `mask_bias` is an additive float bias broadcastable to
    (B, num_heads, L, L), typically (B, 1, 1, L) with 0 / -10000 entries.
    """
    q, k, v = _project_qkv(x, params, num_heads)
    scores = q.float() @ k.float().transpose(-1, -2)
    if mask_bias is not None:
        scores = scores + mask_bias.float()
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    context = (probs.float() @ v.float()).to(x.dtype)
    return dense(merge_heads(context), params.out_proj.kernel, params.out_proj.bias)


def mha(
    x: torch.Tensor, params, num_heads: int, mask_bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Attention through the flash kernel wrapper; `mask_bias` as in
    `mha_plain`, a key bias broadcastable to (B, 1, 1, L)."""
    q, k, v = _project_qkv(x, params, num_heads)
    bias = None
    if mask_bias is not None:
        b, l = x.shape[0], x.shape[1]
        bias = mask_bias.float().expand(b, 1, 1, l).reshape(b, l)
    context, _ = flash.flash_attention_fwd(q, k, v, bias)
    return dense(merge_heads(context), params.out_proj.kernel, params.out_proj.bias)


def mask_to_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Boolean frame mask (B, L) -> additive bias (B, 1, 1, L): masked
    (False) positions get -10000, the reference's bias value."""
    bias = (1.0 - attention_mask.to(dtype)) * -10000.0
    return bias[:, None, None, :]
