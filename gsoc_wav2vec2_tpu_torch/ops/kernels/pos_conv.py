"""Grouped positional convolution + bias + GELU (`csrc/pos_conv.cu`).

Counterpart of `gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py::pos_conv_fused`:
GELU(grouped_conv1d(x, kernel, pad=K//2) + bias), trailing frame cropped
for even K, output (B, T, C).  The kernel is already weight-norm
recomposed, in the JAX layout (K, C // groups, C).  The CUDA kernel tiles
time itself, so it takes any T (the TPU kernel stopped at MAX_T = 2048 and
needed the halo-tiled `pos_conv_blocked` beyond).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..basic import gelu
from . import _build


def pos_conv_plain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
    groups: int, gelu_approx: bool,
) -> torch.Tensor:
    """Same function as the kernel: the kernel is cast to the activation
    dtype and every product accumulates in f32 before bias and GELU."""
    k = kernel.shape[0]
    w = kernel.to(x.dtype).float().permute(2, 1, 0)  # (C, C // groups, K)
    y = F.conv1d(x.float().transpose(1, 2), w, bias.float(), padding=k // 2, groups=groups)
    y = y[:, :, : x.shape[1]].transpose(1, 2)  # crops the even-K trailing frame
    return gelu(y, approximate=gelu_approx).to(x.dtype)


def pos_conv(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
    groups: int, gelu_approx: bool,
) -> torch.Tensor:
    """Kernel wrapper of `pos_conv_plain`."""
    if not x.is_cuda:
        return pos_conv_plain(x, kernel, bias, groups=groups, gelu_approx=gelu_approx)
    b, t, c = x.shape
    k, cg, c_out = kernel.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"pos_conv takes bf16 activations, got {x.dtype}")
    if not gelu_approx:
        raise ValueError("pos_conv computes tanh GELU only, the form every bf16 path takes")
    if c % groups or cg != c // groups or c_out != c or cg not in (16, 48):
        raise ValueError(
            f"pos_conv: kernel {tuple(kernel.shape)} with {groups} groups does not fit "
            f"{c} channels (the kernel takes C // groups of 48, base, or 16)"
        )
    x = x.contiguous()
    # (K, CG, C) -> (G, K * CG, CG): group g's block, rows ordered (tap, in-channel)
    wg = (
        kernel.reshape(k, cg, groups, cg).permute(2, 0, 1, 3)
        .reshape(groups, k * cg, cg).to(torch.bfloat16).contiguous()
    )
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    lib = _build.library()
    _build.check("pos_conv", lib.w2v2_pos_conv(
        x.data_ptr(), wg.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, c, groups, k,
        _build.stream_of(x)))
    pos_conv.launches += 1
    return out


pos_conv.launches = 0
