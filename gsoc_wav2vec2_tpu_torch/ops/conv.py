"""1-D convolutions (counterpart of `gsoc_wav2vec2_tpu/ops/conv.py`).

The public functions keep the JAX package's layout: activations are
(B, T, C) ("NWC") and kernels (K, C_in // groups, C_out) ("WIO").
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .kernels import pos_conv as pos_conv_kernel


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """Strided 1-D convolution, (B, T, C_in) -> (B, T', C_out), with a
    symmetric zero `padding` on the time axis.

    A contiguous (B, T, C) tensor is, viewed as (B, C, 1, T), exactly a
    channels-last 2-D image: run as `conv2d` on that view, cuDNN takes its
    NHWC path and the result comes back (B, T', C_out) contiguous, with no
    layout copies either way (an NCW `conv1d` costs a full transpose of the
    input plus cuDNN's own NCHW/NHWC conversions).
    """
    # WIO -> (C_out, C_in/g, 1, K), channels-last like the input
    w = kernel.to(x.dtype).permute(2, 1, 0).unsqueeze(2)
    w = w.contiguous(memory_format=torch.channels_last)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w, b, stride=(1, stride),
                 padding=(0, padding), groups=groups)
    return y.squeeze(2).transpose(1, 2)


def weight_norm_kernel(weight_v: torch.Tensor, weight_g: torch.Tensor) -> torch.Tensor:
    """Recompose a (K, C_in // groups, C_out) kernel from its weight-norm
    pair: each kernel position is normalised over axes (1, 2) in float32
    and scaled by `weight_g` (K, 1, 1)."""
    v32 = weight_v.float()
    norm = torch.sqrt(torch.sum(v32 * v32, dim=(1, 2), keepdim=True))
    return (v32 / norm * weight_g.float()).to(weight_v.dtype)


def init_weight_g(weight_v: torch.Tensor) -> torch.Tensor:
    """`weight_g` initialiser: the per-kernel-position norm of `weight_v`."""
    v32 = weight_v.float()
    return torch.sqrt(torch.sum(v32 * v32, dim=(1, 2), keepdim=True)).to(weight_v.dtype)


def pos_conv_embed(
    x: torch.Tensor,
    weight_v: torch.Tensor,
    weight_g: torch.Tensor,
    bias: torch.Tensor,
    kernel_size: int,
    groups: int,
    is_gelu_approx: bool = False,
) -> torch.Tensor:
    """Convolutional positional embedding: weight-normed grouped conv with
    a symmetric pad of `kernel_size // 2`, the trailing frame cropped when
    the kernel is even, then GELU.  The caller adds it to `x`.

    Runs through `ops/kernels/pos_conv`: the hand-written kernels for a CUDA
    tensor, their plain versions for a CPU one.  When an input needs a
    gradient it is the `PosConvTrain` autograd function (kernel forward and
    backward); the weight-norm recomposition stays plain torch,
    differentiated by autograd.  Otherwise (inference, a frozen backbone)
    it is the forward kernel alone, called as its `torch.library` operator
    (which `torch.export` keeps).  On the card, where the kernels'
    instances do not cover C, `groups`, `kernel_size` or the dtype
    (`pos_conv.supports`), it is the plain version through autograd.
    """
    kernel = weight_norm_kernel(weight_v, weight_g)
    gelu_approx = is_gelu_approx or x.dtype == torch.bfloat16
    if x.is_cuda and not pos_conv_kernel.supports(x.shape[-1], groups, x.dtype, kernel_size):
        return pos_conv_kernel.pos_conv_plain(x, kernel, bias, groups=groups, gelu_approx=gelu_approx)
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad or bias.requires_grad):
        return pos_conv_kernel.PosConvTrain.apply(x, kernel, bias, groups, gelu_approx)
    return pos_conv_kernel.pos_conv_op(x, kernel, bias, groups, gelu_approx)
