"""Elementary building blocks (counterpart of `gsoc_wav2vec2_tpu/ops/basic.py`).

Normalisation statistics and the norm affine always run in float32 and the
result is cast back to the input dtype, so bfloat16 forwards stay stable.
This slice is inference only: there is no dropout and no stochastic depth
(whose eval-time sum is the plain, un-rescaled residual sum).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU matching `jax.nn.gelu`.  Exact (erf) GELU becomes the tanh form
    in bfloat16, as in the JAX package (`ops/basic.py:31-32`): below bf16
    resolution the two agree and tanh is the cheaper one."""
    if approximate or x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`y = x @ kernel + bias` with a kernel of shape (in, out), cast to the
    activation dtype at use.  The bias rides in the product's epilogue
    (`addmm`): one rounding to the activation dtype instead of two."""
    kernel = kernel.to(x.dtype)
    if bias is None:
        return x @ kernel
    y = torch.addmm(bias.to(x.dtype), x.reshape(-1, x.shape[-1]), kernel)
    return y.reshape(*x.shape[:-1], kernel.shape[-1])


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis: population variance, eps inside the
    sqrt, statistics and affine in float32."""
    y = F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(), eps)
    return y.to(x.dtype)


def group_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over a channels-last (B, T, C) tensor: each group's
    statistics run over (T, C // groups), in float32."""
    y = F.group_norm(x.float().transpose(1, 2), groups, gamma.float(), beta.float(), eps)
    return y.transpose(1, 2).to(x.dtype)
