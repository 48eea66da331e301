"""Fused conv front end, layers 0 + 1 of the feature encoder, both families.

Counterpart of `gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py`.  Base family:

    conv0 (k10 s5, 1 -> C, no bias) -> GroupNorm(C groups) -> GELU
        -> conv1 (k3 s2, C -> C, no bias) -> GELU

Robust/large/XLSR family (`fused_conv01_robust`):

    conv0 + b0 -> LayerNorm -> GELU -> conv1 + b1 -> LayerNorm -> GELU

Three kernels (`csrc/conv_frontend.cu`):

* `groupnorm_stats` replaces `_window_stats` and the XLA tail of
  `fused_conv01` around it: conv0's exact GroupNorm statistics from the
  10x10 Gram matrix and row sum of its sample windows (so conv0 never has to
  exist in device memory), folded into the (B, C) scale and shift that
  `conv01` applies, in one launch (a cluster per batch row whose partials
  are added in rank order: deterministic);
* `conv01` replaces the body of `fused_conv01`: conv0 once per tile,
  normalised with the folded scale/shift, GELU, conv1, GELU, bf16 out;
* `conv01_robust` replaces the body of `fused_conv01_robust`: both
  LayerNorms per frame in f32 inside the kernel, no statistics pass.

`conv01` and `conv01_robust` are one Hopper design templated on the norm
(wgmma fed by TMA, W1 multicast across a cluster of CTAs, warp
specialised); its instances take every multiple of 128 from 128 to 1024
(`KERNEL_WIDTHS`, `supports`): up to 512 a CTA owns all columns of its rows
and keeps conv0 resident, from 640 two CTAs split the columns and conv0 is
made one block of channels at a time.  Past 1024 the card runs the plain
layer loop, where the JAX package takes any multiple of 128.

`groupnorm_stats_plain` is `window_stats_plain` (the Pallas call's
function) followed by `groupnorm_scale_shift` (the XLA tail).  Each kernel has its plain version here; a wrapper runs the plain version for
a CPU tensor and the kernel (or an error) for a CUDA tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..basic import gelu
from . import _build


def _phase_rows(t0: int) -> Tuple[int, int]:
    """Valid rows of the two stride-10 phases: A holds conv0 rows 0, 2, ...
    and B rows 1, 3, ..."""
    return (t0 + 1) // 2, t0 // 2


def conv0_length(num_samples: int) -> int:
    return 1 + (num_samples - 10) // 5


def conv1_length(num_samples: int) -> int:
    return 1 + (conv0_length(num_samples) - 3) // 2


def window_stats_plain(x: torch.Tensor, t0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L) waveform (bf16 on the main path) -> (gram (B, 10, 10),
    row_sum (B, 10)) in f32 over conv0's t0 sample windows."""
    win = x.float().unfold(-1, 10, 5)[:, :t0]  # (B, t0, 10)
    return win.transpose(1, 2) @ win, win.sum(dim=1)


STATS_CLUSTER = 8      # CTAs of a batch row in `groupnorm_stats_kernel`
STATS_ROW_ALIGN = 8    # a CTA's and a chunk's first window pair: a multiple of 8 (80 samples)
STATS_CHUNK_ROWS = 1600  # window pairs a staged chunk holds, at most


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def stats_partition(t0: int, ld: int) -> list:
    """The window pairs (A row r, B row r) of `groupnorm_stats_kernel`, as
    its cluster cuts them: for each CTA rank, its chunks as (first pair,
    pairs, first sample, samples staged); `ld` is the row stride in samples
    (a multiple of 8).  A CTA's pairs start at a multiple of 8; a chunk stages
    its windows' samples and the 5-sample halo of its last B window,
    rounded up to 8 samples (16 bytes) and cut at the row stride."""
    na = _phase_rows(t0)[0]
    per_cta = _round_up(-(-na // STATS_CLUSTER), STATS_ROW_ALIGN)
    out = []
    for rank in range(STATS_CLUSTER):
        r_begin = min(na, rank * per_cta)
        r_end = min(na, r_begin + per_cta)
        chunks = -(-(r_end - r_begin) // STATS_CHUNK_ROWS)
        rows = _round_up(-(-(r_end - r_begin) // chunks), STATS_ROW_ALIGN) if chunks else 0
        cuts = []
        for i in range(chunks):
            r0 = r_begin + i * rows
            n = min(rows, r_end - r0)
            cuts.append((r0, n, 10 * r0, min(_round_up(10 * n + 5, 8), ld - 10 * r0)))
        out.append(cuts)
    return out


def groupnorm_stats_partials(x: torch.Tensor, t0: int) -> torch.Tensor:
    """(B, 8, 65) f32: the partial sums of each CTA of the kernel's cluster,
    in plain torch, computed from the chunks it stages (samples past the
    staged ones read as NaN, so a window that reached them would show).  The
    65 values are the upper triangle of the 10x10 Gram matrix, row by row,
    then the 10 sums; summed over the ranks they are `window_stats_plain`."""
    b, l = x.shape
    ld = _round_up(l, 8)
    na, nb = _phase_rows(t0)
    xf = F.pad(x.float(), (0, ld - l))
    j, k = torch.triu_indices(10, 10)
    part = torch.zeros((b, STATS_CLUSTER, 65), dtype=torch.float32, device=x.device)
    for rank, cuts in enumerate(stats_partition(t0, ld)):
        for r0, n, s0, staged in cuts:
            chunk = torch.full((b, 10 * n + 16), float("nan"), device=x.device)
            chunk[:, :staged] = xf[:, s0: s0 + staged]
            wins = [chunk[:, : 10 * n].reshape(b, n, 10)]
            nb_here = min(n, max(0, nb - r0))  # B rows past nb are masked
            wins.append(chunk[:, 5: 5 + 10 * nb_here].reshape(b, nb_here, 10))
            for win in wins:
                part[:, rank] += torch.cat([win[..., j] * win[..., k], win], dim=-1).sum(dim=1)
    return part


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


def groupnorm_stats_plain(
    x: torch.Tensor, t0: int, w0: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L) waveform -> (scale, shift), (B, C) f32: conv0's GroupNorm
    over its t0 rows folded into a per-channel affine map."""
    gram, row_sum = window_stats_plain(x, t0)
    return groupnorm_scale_shift(gram, row_sum, w0, gamma, beta, t0, eps)


def groupnorm_stats(
    x: torch.Tensor, t0: int, w0: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of `groupnorm_stats_plain` (replaces Pallas
    `_window_stats` and the XLA tail of `fused_conv01`): one launch, a
    cluster per batch row; the same bits on a relaunch."""
    if not x.is_cuda:
        return groupnorm_stats_plain(x, t0, w0, gamma, beta, eps)
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(
            f"groupnorm_stats takes a (B, L) bf16 waveform, got {x.dtype} {tuple(x.shape)}")
    b, l = x.shape
    c = w0.shape[-1]
    if t0 < 1 or conv0_length(l) < t0:
        raise ValueError(f"groupnorm_stats: {t0} conv0 rows do not fit {l} samples")
    if tuple(w0.shape) != (10, 1, c) or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("groupnorm_stats takes w0 (10, 1, C) and (C,) gamma, beta")
    # the bulk copies take 16-byte rows on 16-byte addresses
    ld = _round_up(l, 8)
    x = x.contiguous() if ld == l else F.pad(x, (0, ld - l))
    if x.data_ptr() % 16:
        x = x.clone()
    w0f = w0.reshape(10, c).float().contiguous()
    g, bt = gamma.float().contiguous(), beta.float().contiguous()
    scale = torch.empty((b, c), dtype=torch.float32, device=x.device)
    shift = torch.empty((b, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    _build.check("groupnorm_stats", lib.w2v2_groupnorm_stats(
        x.data_ptr(), w0f.data_ptr(), g.data_ptr(), bt.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), b, l, ld, t0, c, eps, _build.stream_of(x)))
    groupnorm_stats.launches += 1
    return scale, shift


groupnorm_stats.launches = 0


# the widths C of the conv01 kernels' instances (`launch_conv01` in
# csrc/conv_frontend.cu): every multiple of 128 that the JAX package sends to
# Pallas, up to 1024
KERNEL_WIDTHS = (128, 256, 384, 512, 640, 768, 896, 1024)


def _taps16(w0: torch.Tensor, c: int) -> torch.Tensor:
    """W0 (10, 1, C) as the kernels read it: (16, C) bf16, taps 10-15 zero
    (conv0 is a k16 product on the tensor cores)."""
    w = torch.zeros((16, c), dtype=torch.bfloat16, device=w0.device)
    w[:10] = w0.reshape(10, c)
    return w


def conv01_plain(
    x: torch.Tensor, w0: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    w1: torch.Tensor, t1: int, gelu_approx: bool, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x: (B, L) bf16 waveform; w0 (10, 1, C); w1 (3, C, C) (JAX layout);
    scale/shift (B, C) f32 -> (B, t1, C) bf16.  Products of bf16 values
    accumulate in f32, as in the kernel.  `out_dtype` f32 returns the
    output before its last rounding."""
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
    return gelu(y1, approximate=gelu_approx).to(out_dtype)


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
    if tuple(w0.shape) != (10, 1, c) or tuple(w1.shape) != (3, c, c) or c not in KERNEL_WIDTHS:
        raise ValueError(
            f"conv01 takes w0 (10, 1, C), w1 (3, C, C) with C in {KERNEL_WIDTHS}, got "
            f"{tuple(w0.shape)}, {tuple(w1.shape)}"
        )
    b, l = x.shape
    if t1 < 1 or conv1_length(l) < t1:
        raise ValueError(f"conv01: {t1} output rows do not fit {l} samples")
    x = x.contiguous()
    w0b = _taps16(w0, c)
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
    t1 = conv1_length(x.shape[-1])
    scale, shift = groupnorm_stats(x, t0, w0, gamma, beta, eps)
    return conv01(x, w0, scale, shift, w1, t1, gelu_approx)


def conv01_robust_plain(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, gamma0: torch.Tensor,
    beta0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, gamma1: torch.Tensor,
    beta1: torch.Tensor, t1: int, eps: float, gelu_approx: bool,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x: (B, L) bf16 waveform; w0 (10, 1, C); w1 (3, C, C) (JAX layout);
    biases and LayerNorm affines (C,) -> (B, t1, C) bf16.  Products of bf16
    values accumulate in f32 and both LayerNorms run in f32 over the
    channels of a frame, as in the kernel; conv0's activations are rounded
    to bf16 before conv1.  `out_dtype` f32 returns the output before its
    last rounding."""
    c = w0.shape[-1]
    win = x.float().unfold(-1, 10, 5)[:, : 2 * t1 + 1]  # conv0 rows 0 .. 2 t1
    y0 = win @ w0.reshape(10, c).to(torch.bfloat16).float() + b0.float()
    y0 = F.layer_norm(y0, (c,), gamma0.float(), beta0.float(), eps)
    y0 = gelu(y0, approximate=gelu_approx).to(torch.bfloat16).float()
    w1f = w1.to(torch.bfloat16).float()
    y1 = (
        y0[:, 0 : 2 * t1 : 2] @ w1f[0]
        + y0[:, 1 : 2 * t1 + 1 : 2] @ w1f[1]
        + y0[:, 2 : 2 * t1 + 1 : 2] @ w1f[2]
    ) + b1.float()
    y1 = F.layer_norm(y1, (c,), gamma1.float(), beta1.float(), eps)
    return gelu(y1, approximate=gelu_approx).to(out_dtype)


def conv01_robust(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, gamma0: torch.Tensor,
    beta0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, gamma1: torch.Tensor,
    beta1: torch.Tensor, t1: int, eps: float, gelu_approx: bool,
) -> torch.Tensor:
    """Kernel wrapper of `conv01_robust_plain` (replaces the Pallas call of
    `fused_conv01_robust`)."""
    if not x.is_cuda:
        return conv01_robust_plain(x, w0, b0, gamma0, beta0, w1, b1, gamma1, beta1, t1, eps,
                                   gelu_approx)
    c = w0.shape[-1]
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(
            f"conv01_robust takes a (B, L) bf16 waveform, got {x.dtype} {tuple(x.shape)}")
    if not gelu_approx:
        raise ValueError("conv01_robust computes tanh GELU only, the form every bf16 path takes")
    if tuple(w0.shape) != (10, 1, c) or tuple(w1.shape) != (3, c, c) or c not in KERNEL_WIDTHS:
        raise ValueError(
            f"conv01_robust takes w0 (10, 1, C), w1 (3, C, C) with C in {KERNEL_WIDTHS}, got "
            f"{tuple(w0.shape)}, {tuple(w1.shape)}"
        )
    b, l = x.shape
    if t1 < 1 or conv1_length(l) < t1:
        raise ValueError(f"conv01_robust: {t1} output rows do not fit {l} samples")
    x = x.contiguous()
    w0b = _taps16(w0, c)
    w1b = w1.to(torch.bfloat16).contiguous()
    # rows [bias, gamma, beta] of each conv, f32
    p0 = torch.stack([b0, gamma0, beta0]).float().contiguous()
    p1 = torch.stack([b1, gamma1, beta1]).float().contiguous()
    if p0.shape != (3, c) or p1.shape != (3, c):
        raise ValueError("conv01_robust takes (C,) biases and LayerNorm affines")
    out = torch.empty((b, t1, c), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    _build.check("conv01_robust", lib.w2v2_conv01_robust(
        x.data_ptr(), w0b.data_ptr(), p0.data_ptr(), w1b.data_ptr(), p1.data_ptr(),
        out.data_ptr(), b, l, t1, c, eps, _build.stream_of(x)))
    conv01_robust.launches += 1
    return out


conv01_robust.launches = 0


def fused_conv01_robust(
    waveform: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, gamma0: torch.Tensor,
    beta0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, gamma1: torch.Tensor,
    beta1: torch.Tensor, *, eps: float = 1e-5, gelu_approx: bool = False,
) -> torch.Tensor:
    """conv0(k10,s5)+bias -> LayerNorm -> GELU -> conv1(k3,s2)+bias ->
    LayerNorm -> GELU.  waveform (B, L) float, cast to bf16 first as in the
    JAX kernel; returns (B, T1, C) bf16.  LayerNorm is per frame, so there is
    no statistics pass."""
    x = waveform.to(torch.bfloat16)
    return conv01_robust(x, w0, b0, gamma0, beta0, w1, b1, gamma1, beta1,
                         conv1_length(x.shape[-1]), eps, gelu_approx)


# The two front ends as `torch.library` operators: `torch.export` keeps them
# in its graph as opaque calls, so an exported program launches the kernels
# (export/torch_export.py).  Each runs the wrapper above (the kernels for
# CUDA tensors, the plain versions for CPU ones); its fake gives the output's
# shape and dtype to tracing.


@torch.library.custom_op("w2v2::fused_conv01", mutates_args=())
def fused_conv01_op(waveform: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, w1: torch.Tensor, eps: float,
                    gelu_approx: bool) -> torch.Tensor:
    """`fused_conv01` as an operator."""
    return fused_conv01(waveform, w0, gamma, beta, w1, eps=eps, gelu_approx=gelu_approx)


@fused_conv01_op.register_fake
def _(waveform, w0, gamma, beta, w1, eps, gelu_approx):
    t1 = conv1_length(waveform.shape[-1])
    return waveform.new_empty((waveform.shape[0], t1, w0.shape[-1]), dtype=torch.bfloat16)


@torch.library.custom_op("w2v2::fused_conv01_robust", mutates_args=())
def fused_conv01_robust_op(waveform: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                           gamma0: torch.Tensor, beta0: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, gamma1: torch.Tensor, beta1: torch.Tensor,
                           eps: float, gelu_approx: bool) -> torch.Tensor:
    """`fused_conv01_robust` as an operator."""
    return fused_conv01_robust(waveform, w0, b0, gamma0, beta0, w1, b1, gamma1, beta1,
                               eps=eps, gelu_approx=gelu_approx)


@fused_conv01_robust_op.register_fake
def _(waveform, w0, b0, gamma0, beta0, w1, b1, gamma1, beta1, eps, gelu_approx):
    t1 = conv1_length(waveform.shape[-1])
    return waveform.new_empty((waveform.shape[0], t1, w0.shape[-1]), dtype=torch.bfloat16)


def _geometry_ok(config) -> bool:
    return (
        len(config.kernal_sizes) >= 2
        and config.kernal_sizes[0] == 10
        and config.strides[0] == 5
        and config.kernal_sizes[1] == 3
        and config.strides[1] == 2
        and config.filter_sizes[0] == config.filter_sizes[1]
    )


def fusable(config) -> bool:
    """Both conv-stack families: base (GroupNorm on layer 0, no bias:
    `fused_conv01`) and robust/large/XLSR (LayerNorm on every layer, biases:
    `fused_conv01_robust`), at conv0 k10 s5 and conv1 k3 s2 of equal
    widths: the JAX package's `supports` without its rule that the width be
    a multiple of 128, since the plain versions (a CPU tensor) take any
    width."""
    if not _geometry_ok(config):
        return False
    if config.feature_extractor_norm_type == "group":
        return not config.conv_bias
    return config.feature_extractor_norm_type == "layer"


def supports(config) -> bool:
    """Whether the conv01 kernels' instances cover `config` on the card: a
    `fusable` front end whose width is in `KERNEL_WIDTHS` (the JAX package's
    multiples of 128, up to 1024).  Elsewhere the card runs the plain layer
    loop, as the JAX package runs XLA's convolutions."""
    return fusable(config) and config.filter_sizes[0] in KERNEL_WIDTHS
