"""Fused conv front end, layers 0 + 1 of the base feature encoder.

Counterpart of `gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py`:

    conv0 (k10 s5, 1 -> C, no bias) -> GroupNorm(C groups) -> GELU
        -> conv1 (k3 s2, C -> C, no bias) -> GELU

Two kernels (`csrc/conv_frontend.cu`):

* `window_stats` replaces `_window_stats`: conv0's exact GroupNorm
  statistics from the 10x10 Gram matrix and row sum of its sample windows,
  so conv0 never has to exist in device memory;
* `conv01` replaces the body of `fused_conv01`: conv0 recomputed per tile,
  normalised with the folded scale/shift, GELU, conv1, GELU, bf16 out.

The scale/shift algebra between them (`groupnorm_scale_shift`) is plain
torch on (B, C) tensors, as it is XLA code outside the Pallas calls in JAX.
Each kernel has its plain version here; a wrapper runs the plain version for
a CPU tensor and the kernel (or an error) for a CUDA tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..basic import gelu
from . import _build


def _phase_rows(t0: int) -> Tuple[int, int]:
    """Valid rows of the two stride-10 phases: A holds conv0 rows 0, 2, ...
    and B rows 1, 3, ..."""
    return (t0 + 1) // 2, t0 // 2


def conv0_length(num_samples: int) -> int:
    return 1 + (num_samples - 10) // 5


def window_stats_plain(x: torch.Tensor, t0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L) waveform (bf16 on the main path) -> (gram (B, 10, 10),
    row_sum (B, 10)) in f32 over conv0's t0 sample windows."""
    win = x.float().unfold(-1, 10, 5)[:, :t0]  # (B, t0, 10)
    return win.transpose(1, 2) @ win, win.sum(dim=1)


def window_stats(x: torch.Tensor, t0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of `window_stats_plain` (f32 atomics: the last bits
    vary run to run on the card)."""
    if not x.is_cuda:
        return window_stats_plain(x, t0)
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"window_stats takes a (B, L) bf16 waveform, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    b, l = x.shape
    if t0 < 1 or conv0_length(l) < t0:
        raise ValueError(f"window_stats: {t0} conv0 rows do not fit {l} samples")
    na, nb = _phase_rows(t0)
    out = torch.zeros((b, 110), dtype=torch.float32, device=x.device)
    lib = _build.library()
    _build.check("window_stats", lib.w2v2_window_stats(
        x.data_ptr(), out.data_ptr(), b, l, na, nb, _build.stream_of(x)))
    window_stats.launches += 1
    return out[:, :100].reshape(b, 10, 10), out[:, 100:]


window_stats.launches = 0


def groupnorm_scale_shift(
    gram: torch.Tensor, row_sum: torch.Tensor, w0: torch.Tensor,
    gamma: torch.Tensor, beta: torch.Tensor, t0: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm(C groups) of conv0 folded into per-(batch, channel)
    `scale`, `shift` (f32, (B, C)): mean = row_sum @ W0 / t0, E[y^2] =
    diag(W0^T G W0) / t0, var clamped at 0 (E[y^2] - mean^2 cancels in f32
    on DC-heavy audio)."""
    c = w0.shape[-1]
    w0f = w0.reshape(10, c).float()
    mean = (row_sum @ w0f) / t0
    sumsq = torch.einsum("bjk,jc,kc->bc", gram, w0f, w0f)
    var = torch.clamp(sumsq / t0 - mean * mean, min=0.0)
    scale = torch.rsqrt(var + eps) * gamma.float()[None, :]
    shift = beta.float()[None, :] - mean * scale
    return scale, shift


def conv01_plain(
    x: torch.Tensor, w0: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    w1: torch.Tensor, t1: int, gelu_approx: bool,
) -> torch.Tensor:
    """x: (B, L) bf16 waveform; w0 (10, 1, C); w1 (3, C, C) (JAX layout);
    scale/shift (B, C) f32 -> (B, t1, C) bf16.  Products of bf16 values
    accumulate in f32, as in the kernel."""
    c = w0.shape[-1]
    win = x.float().unfold(-1, 10, 5)[:, : 2 * t1 + 1]  # conv0 rows 0 .. 2 t1
    y0 = win @ w0.reshape(10, c).to(torch.bfloat16).float()
    y0 = gelu(y0 * scale[:, None, :] + shift[:, None, :], approximate=gelu_approx)
    y0 = y0.to(torch.bfloat16).float()
    w1f = w1.to(torch.bfloat16).float()
    y1 = (
        y0[:, 0 : 2 * t1 : 2] @ w1f[0]
        + y0[:, 1 : 2 * t1 + 1 : 2] @ w1f[1]
        + y0[:, 2 : 2 * t1 + 1 : 2] @ w1f[2]
    )
    return gelu(y1, approximate=gelu_approx).to(torch.bfloat16)


def conv01(
    x: torch.Tensor, w0: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    w1: torch.Tensor, t1: int, gelu_approx: bool,
) -> torch.Tensor:
    """Kernel wrapper of `conv01_plain` (replaces Pallas `fused_conv01`)."""
    if not x.is_cuda:
        return conv01_plain(x, w0, scale, shift, w1, t1, gelu_approx)
    c = w0.shape[-1]
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"conv01 takes a (B, L) bf16 waveform, got {x.dtype} {tuple(x.shape)}")
    if not gelu_approx:
        raise ValueError("conv01 computes tanh GELU only, the form every bf16 path takes")
    if tuple(w0.shape) != (10, 1, c) or tuple(w1.shape) != (3, c, c) or c % 256:
        raise ValueError(
            f"conv01 takes w0 (10, 1, C), w1 (3, C, C) with C % 256 == 0, got "
            f"{tuple(w0.shape)}, {tuple(w1.shape)}"
        )
    b, l = x.shape
    if t1 < 1 or 1 + (conv0_length(l) - 3) // 2 < t1:
        raise ValueError(f"conv01: {t1} output rows do not fit {l} samples")
    x = x.contiguous()
    w0b = w0.reshape(10, c).to(torch.bfloat16).contiguous()
    w1b = w1.to(torch.bfloat16).contiguous()
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    out = torch.empty((b, t1, c), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    _build.check("conv01", lib.w2v2_conv01(
        x.data_ptr(), w0b.data_ptr(), scale.data_ptr(), shift.data_ptr(), w1b.data_ptr(),
        out.data_ptr(), b, l, t1, c, _build.stream_of(x)))
    conv01.launches += 1
    return out


conv01.launches = 0


def fused_conv01(
    waveform: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
    beta: torch.Tensor, w1: torch.Tensor, *, eps: float = 1e-5,
    gelu_approx: bool = False,
) -> torch.Tensor:
    """conv0(k10,s5) -> GroupNorm(C groups) -> GELU -> conv1(k3,s2) -> GELU.

    waveform (B, L) float; w0 (10, 1, C); w1 (3, C, C); gamma/beta (C,).
    Returns (B, T1, C) bf16.  The waveform is cast to bf16 first, as in
    the JAX kernel.
    """
    x = waveform.to(torch.bfloat16)
    t0 = conv0_length(x.shape[-1])
    t1 = 1 + (t0 - 3) // 2
    gram, row_sum = window_stats(x, t0)
    scale, shift = groupnorm_scale_shift(gram, row_sum, w0, gamma, beta, t0, eps)
    return conv01(x, w0, scale, shift, w1, t1, gelu_approx)


def supports(config) -> bool:
    """Base-family geometry the fused path computes: conv0 k10 s5 and conv1
    k3 s2 with equal widths, GroupNorm on layer 0, no conv bias."""
    return (
        len(config.kernal_sizes) >= 2
        and config.kernal_sizes[0] == 10
        and config.strides[0] == 5
        and config.kernal_sizes[1] == 3
        and config.strides[1] == 2
        and config.filter_sizes[0] == config.filter_sizes[1]
        and config.feature_extractor_norm_type == "group"
        and not config.conv_bias
    )
