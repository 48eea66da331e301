"""Grouped positional convolution (`csrc/pos_conv.cuh`, instantiated in
`csrc/pos_conv.cu` and `csrc/pos_conv_odd8.cu`): the inference forward, and
the training forward with its backward kernels, at every multiple of 8 up
to 128 channels a group (`WIDTHS`).

Counterpart of `gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py`:

* `pos_conv` replaces `pos_conv_fused`: GELU(grouped_conv1d(x, kernel,
  pad=K//2) + bias), trailing frame cropped for even K, output (B, T, C);
* `pos_conv_train_fwd` replaces `_fwd_train_call`: the same output and the
  f32 pre-activation (conv + bias), kept for the exact GELU';
* `pos_conv_dx` replaces `_dx_call`: the correlation of dpre with the
  tap-flipped, in/out-swapped kernel, pad (K/2 - 1, K/2);
* `pos_conv_dw` replaces `_dw_call`: dW = sum over (b, t) of the input
  window times dpre, f32, in the kernel layout (K, C // groups, C);
* `PosConvTrain` is the `torch.autograd.Function` of JAX's custom VJP
  `_train_core`; GELU' and db = sum(dpre) stay plain torch around the
  kernels, as they are XLA code in JAX.

The kernel is already weight-norm recomposed, in the JAX layout
(K, C // groups, C); the CUDA kernels take it in that layout, cast to bf16
(dx reads it with the taps flipped and the channels swapped, without a
copy).  The CUDA kernels tile time themselves, so they take any T (the TPU
kernels stopped at MAX_T = 2048 and needed the halo-tiled
`pos_conv_blocked` beyond).  The pre-activation and dpre are (B, T, C) here
(JAX keeps them grouped, (B, G, T, C // G)).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..basic import gelu
from . import _build


SMEM_PER_BLOCK = 232_448  # bytes of dynamic shared memory an sm_90 block may take
DW_TIME_TILE = 64  # time steps a stage of the dW kernel


def tap_rows(cg: int) -> int:
    """A tap's C // groups channels padded with zeros to whole k steps of 16
    (`FwdLayout::kKRows`): cg + 8 where cg is an odd multiple of 8 (8, 24,
    .., 104, 120), cg at the multiples of 16."""
    return -(-cg // 16) * 16


def dw_tap_rows(cg: int, taps: int) -> int:
    """M rows a tap of the dW kernel (`DwLayout::kTapRows`): `tap_rows`, or
    128 where `taps` taps of it would not fill whole 128-row warpgroup
    halves (at 72 with 4 taps a CTA, 104 with 3, 112 with 4, 120 with 6)."""
    rows = tap_rows(cg)
    return 128 if taps * rows % 128 else rows


def dw_window_cols(cg: int) -> int:
    """Channels a row of the dW kernel's x window (`DwLayout::kXCols`): a
    64-channel box with the 128-byte swizzle up to 64 channels a group;
    wider, unswizzled, the channels its M rows read (cg, or `dw_tap_rows` -
    8 where a padding row reads past cg), 8 more where that is an even
    number of 16-byte units, so that the row pitch is odd (88 at 80 and 88,
    104 at 96, 120 at 72, 104, 112 and 120, 136 at 128)."""
    if cg <= 64:
        return 64
    reach = max(cg, dw_tap_rows(cg, WIDTHS[cg].dw_taps) - 8)
    return reach if (reach // 8) % 2 else reach + 8


def fwd_smem_bytes(cg: int, kernel_size: int) -> int:
    """Dynamic shared memory of the forward / dx kernel (`FwdLayout::bytes`):
    1024 bytes of alignment slack, 4 weight slots of ceil(cg / 64) boxes of
    `tap_rows` rows x 64 columns, 8 bytes a barrier, and a window of 256 + K
    rows of `tap_rows` bf16 channels."""
    rows = tap_rows(cg)
    return 1024 + 4 * -(-cg // 64) * rows * 64 * 2 + 2 * 4 * 8 + (256 + kernel_size) * rows * 2


@dataclasses.dataclass(frozen=True)
class Width:
    """One C // groups the CUDA kernels are instantiated for: a case of both
    C switches, the forward / dx one (`dispatch` in `csrc/pos_conv.cu`,
    `dispatch_odd8` in `csrc/pos_conv_odd8.cu`) and the dW one
    (`w2v2_pos_conv_dw`, `dw_odd8`), whose `launch_dw<CG, kTapStep, kTaps,
    kNSplit>` gives the last three fields."""

    cg: int
    tap_step: int    # kTapStep: the tap counts the instance takes are its multiples
    dw_taps: int     # kTaps: taps a dW CTA, M = taps * `dw_tap_rows`
    dw_n_split: int  # kNSplit: CTAs that share a tap block's output channels (N = cg / it)

    @property
    def max_taps(self) -> int:
        """The most taps, a multiple of `tap_step`, whose input window fits
        the forward / dx kernel's shared memory beside its weight ring (132
        at 120 and 128 channels a group)."""
        room = (SMEM_PER_BLOCK - fwd_smem_bytes(self.cg, 0)) // (2 * tap_rows(self.cg))
        return room // self.tap_step * self.tap_step


WIDTHS = {w.cg: w for w in (
    Width(8, 8, 16, 1),    # robust/large widths in 128 groups
    Width(16, 8, 32, 1),   # the narrow geometry of the tests
    Width(24, 4, 16, 1),   # base widths in 32 groups
    Width(32, 4, 16, 1),   # 512 channels in 16 groups
    Width(40, 8, 16, 1),   # 640 channels in 16 groups
    Width(48, 8, 16, 1),   # base
    Width(56, 4, 8, 1),    # 896 channels in 16 groups
    Width(64, 4, 8, 1),    # robust/large
    Width(72, 4, 4, 1),    # 1152 channels in 16 groups: N = 72 over two dpre boxes
    Width(80, 8, 8, 2),    # the 1280-d family (HuBERT-xlarge, XLS-R 1B)
    Width(88, 4, 4, 1),    # 1408 channels in 16 groups: N = 88 over two dpre boxes
    Width(96, 4, 8, 2),    # base widths in 8 groups
    Width(104, 4, 3, 1),   # 1664 channels in 16 groups: N = 104 over two dpre boxes
    Width(112, 4, 4, 2),   # 1792 channels in 16 groups
    Width(120, 4, 6, 3),   # XLS-R 2B's 1920-d
    Width(128, 4, 4, 2),   # robust/large widths in 8 groups
)}


def supports(c: int, groups: int, dtype: torch.dtype, kernel_size: int = 128) -> bool:
    """Whether the pos-conv kernels' instances cover a (.., C) activation of
    `dtype` convolved in `groups` groups with `kernel_size` taps: bf16, C //
    groups in `WIDTHS` (every multiple of 8 up to 128), a tap count that is
    a multiple of the width's `tap_step` (4 or 8) and at most its
    `max_taps` (132 at 120 and 128).  Elsewhere (C // groups past 128 or
    off the multiples of 8, f32) the card runs `pos_conv_plain` through
    autograd, as the JAX package runs XLA's conv."""
    if dtype != torch.bfloat16 or groups < 1 or c % groups:
        return False
    w = WIDTHS.get(c // groups)
    return w is not None and kernel_size % w.tap_step == 0 and kernel_size <= w.max_taps


def _conv_plain(x: torch.Tensor, kernel: torch.Tensor, groups: int, pad_lo: int) -> torch.Tensor:
    """sum_{k, i} x[t + k - pad_lo, g*CG + i] * kernel[k, i, g*CG + o] in f32
    from operands rounded to x's dtype; zero outside [0, T); (B, T, C) out."""
    k = kernel.shape[0]
    w = kernel.to(x.dtype).float().permute(2, 1, 0)  # (C, C // groups, K)
    xp = F.pad(x.float().transpose(1, 2), (pad_lo, k - 1 - pad_lo))
    return F.conv1d(xp, w, groups=groups).transpose(1, 2)


def pos_conv_plain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
    groups: int, gelu_approx: bool,
) -> torch.Tensor:
    """Same function as the kernel: the kernel is cast to the activation
    dtype and every product accumulates in f32 before bias and GELU."""
    y = _conv_plain(x, kernel, groups, kernel.shape[0] // 2) + bias.float()
    return gelu(y, approximate=gelu_approx).to(x.dtype)


def _check(name, x, kernel, groups):
    b, t, c = x.shape
    k, cg, c_out = kernel.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 activations, got {x.dtype}")
    if c % groups or cg != c // groups or c_out != c or cg not in WIDTHS:
        raise ValueError(
            f"{name}: kernel {tuple(kernel.shape)} with {groups} groups does not fit "
            f"{c} channels (the kernel takes C // groups of {sorted(WIDTHS)})"
        )
    return b, t, c, k, cg


def dw_splits(kernel_size: int, cg: int, groups: int, b: int, t: int, sms: int) -> int:
    """How many CTAs share each dW tile block's time tiles: 1 where the tile
    blocks (ceil(K / `dw_taps`) per group, each `dw_n_split` CTAs) fill the
    `sms` SMs, else as many as fit, at most one per time tile."""
    w = WIDTHS[cg]
    blocks = -(-kernel_size // w.dw_taps) * groups * w.dw_n_split
    tiles = b * -(-t // DW_TIME_TILE)
    return max(1, min(sms // blocks, tiles))


def pos_conv(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
    groups: int, gelu_approx: bool,
) -> torch.Tensor:
    """Kernel wrapper of `pos_conv_plain`."""
    if not x.is_cuda:
        return pos_conv_plain(x, kernel, bias, groups=groups, gelu_approx=gelu_approx)
    b, t, c, k, _ = _check("pos_conv", x, kernel, groups)
    if not gelu_approx:
        raise ValueError("pos_conv computes tanh GELU only, the form every bf16 path takes")
    x = x.contiguous()
    w = kernel.to(torch.bfloat16).contiguous()
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    lib = _build.library()
    _build.check("pos_conv", lib.w2v2_pos_conv(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, c, groups, k,
        _build.stream_of(x)))
    pos_conv.launches += 1
    return out


pos_conv.launches = 0


@torch.library.custom_op("w2v2::pos_conv", mutates_args=())
def pos_conv_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, groups: int,
                gelu_approx: bool) -> torch.Tensor:
    """`pos_conv` as a `torch.library` operator, which `torch.export` keeps
    in its graph (the kernel for a CUDA tensor, the plain version for a CPU
    one)."""
    return pos_conv(x, kernel, bias, groups=groups, gelu_approx=gelu_approx)


@pos_conv_op.register_fake
def _(x, kernel, bias, groups, gelu_approx):
    b, t, c = x.shape
    # the kernel writes (B, T, C); the plain version returns a (B, C, T) conv transposed
    return x.new_empty((b, t, c)) if x.device.type == "cuda" else x.new_empty((b, c, t)).transpose(1, 2)


def pos_conv_train_fwd_plain(x, kernel, bias, *, groups: int, gelu_approx: bool):
    """(GELU(pre) in x's dtype, pre (B, T, C) f32), pre = conv + bias."""
    pre = _conv_plain(x, kernel, groups, kernel.shape[0] // 2) + bias.float()
    return gelu(pre, approximate=gelu_approx).to(x.dtype), pre


def pos_conv_train_fwd(x, kernel, bias, *, groups: int, gelu_approx: bool):
    """Kernel wrapper of `pos_conv_train_fwd_plain`."""
    if not x.is_cuda:
        return pos_conv_train_fwd_plain(x, kernel, bias, groups=groups, gelu_approx=gelu_approx)
    b, t, c, k, _ = _check("pos_conv_train_fwd", x, kernel, groups)
    if not gelu_approx:
        raise ValueError("pos_conv_train_fwd computes tanh GELU only, the form every bf16 path takes")
    x = x.contiguous()
    w = kernel.to(torch.bfloat16).contiguous()
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    pre = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _build.library()
    _build.check("pos_conv_train_fwd", lib.w2v2_pos_conv_train_fwd(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), pre.data_ptr(),
        b, t, c, groups, k, _build.stream_of(x)))
    pos_conv_train_fwd.launches += 1
    return out, pre


pos_conv_train_fwd.launches = 0


def dx_kernel(kernel: torch.Tensor, groups: int) -> torch.Tensor:
    """The dx correlation's kernel in the (K, CG, C) layout: taps flipped and,
    within each group, input and output channels swapped."""
    k, cg, c = kernel.shape
    return (kernel.reshape(k, cg, groups, cg).flip(0).permute(0, 3, 2, 1)
            .reshape(k, cg, c))


def pos_conv_dx_plain(dpre: torch.Tensor, kernel: torch.Tensor, *, groups: int) -> torch.Tensor:
    """dx (B, T, C) in dpre's dtype: the forward conv of dpre with
    `dx_kernel(kernel)` and pad (K/2 - 1, K/2), f32 sums."""
    k = kernel.shape[0]
    return _conv_plain(dpre, dx_kernel(kernel, groups), groups, k // 2 - 1).to(dpre.dtype)


def pos_conv_dx(dpre: torch.Tensor, kernel: torch.Tensor, *, groups: int) -> torch.Tensor:
    """Kernel wrapper of `pos_conv_dx_plain` (dpre in bf16 on the card)."""
    if not dpre.is_cuda:
        return pos_conv_dx_plain(dpre, kernel, groups=groups)
    b, t, c, k, _ = _check("pos_conv_dx", dpre, kernel, groups)
    dpre = dpre.contiguous()
    w = kernel.to(torch.bfloat16).contiguous()  # flipped and swapped by the kernel
    dx = torch.empty_like(dpre)
    lib = _build.library()
    _build.check("pos_conv_dx", lib.w2v2_pos_conv_dx(
        dpre.data_ptr(), w.data_ptr(), dx.data_ptr(), b, t, c, groups, k, _build.stream_of(dpre)))
    pos_conv_dx.launches += 1
    return dx


pos_conv_dx.launches = 0


def pos_conv_dw_plain(x: torch.Tensor, dpre: torch.Tensor, kernel_size: int, *,
                      groups: int) -> torch.Tensor:
    """dW (K, C // groups, C) f32: dW[k, i, g*CG + o] = sum over (b, t) of
    x[b, t + k - K/2, g*CG + i] * dpre[b, t, g*CG + o] (zero outside [0, T)),
    one batched product per tap."""
    b, t, c = x.shape
    k, cg = kernel_size, c // groups
    xp = F.pad(x.float(), (0, 0, k // 2, k - 1 - k // 2))  # (B, T + K - 1, C)
    d = dpre.float().reshape(b * t, groups, cg).permute(1, 0, 2)  # (G, BT, CG)
    dw = torch.empty((k, cg, c), dtype=torch.float32, device=x.device)
    for tap in range(k):
        win = xp[:, tap:tap + t].reshape(b * t, groups, cg).permute(1, 2, 0)  # (G, CG, BT)
        dw[tap] = (win @ d).permute(1, 0, 2).reshape(cg, c)
    return dw


def pos_conv_dw(x: torch.Tensor, dpre: torch.Tensor, kernel_size: int, *,
                groups: int) -> torch.Tensor:
    """Kernel wrapper of `pos_conv_dw_plain` (x and dpre bf16 on the card).
    Where the tile blocks do not fill the card, `dw_splits` CTAs share each
    block's time tiles, and their partials are summed in a fixed order."""
    if not x.is_cuda:
        return pos_conv_dw_plain(x, dpre, kernel_size, groups=groups)
    b, t, c = x.shape
    k, cg = kernel_size, c // groups
    if x.dtype != torch.bfloat16 or dpre.dtype != torch.bfloat16 or dpre.shape != x.shape:
        raise ValueError("pos_conv_dw takes bf16 x and dpre of one (B, T, C) shape")
    if c % groups or cg not in WIDTHS or k % WIDTHS[cg].tap_step:
        raise ValueError(
            f"pos_conv_dw takes C // groups of {sorted(WIDTHS)} and a multiple of "
            f"its tap step (4 or 8) taps, got {c} channels, {groups} groups, {k} taps"
        )
    x, dpre = x.contiguous(), dpre.contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = dw_splits(k, cg, groups, b, t, sms)
    part = (torch.empty((splits, groups, k * cg, cg), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    dw = torch.empty((k, cg, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    _build.check("pos_conv_dw", lib.w2v2_pos_conv_dw(
        x.data_ptr(), dpre.data_ptr(), None if part is None else part.data_ptr(), dw.data_ptr(),
        b, t, c, groups, k, splits, _build.stream_of(x)))
    pos_conv_dw.launches += 1
    return dw


pos_conv_dw.launches = 0


class PosConvTrain(torch.autograd.Function):
    """GELU(grouped conv + bias) with the kernels' backward (JAX's
    `_train_core` / `_train_fwd` / `_train_bwd`).  Saves x, the kernel and
    the f32 pre-activation; the backward takes GELU' from the saved
    pre-activation, db = sum(dpre), and dx, dW from the kernels (their plain
    versions for CPU tensors), with dpre cast to x's dtype first."""

    @staticmethod
    def forward(ctx, x, kernel, bias, groups: int, gelu_approx: bool):
        y, pre = pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=gelu_approx)
        ctx.save_for_backward(x, kernel, pre)
        ctx.groups, ctx.gelu_approx, ctx.bias_dtype = groups, gelu_approx, bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel, pre = ctx.saved_tensors
        dpre = torch.ops.aten.gelu_backward(
            dy.float(), pre, approximate="tanh" if ctx.gelu_approx else "none")
        dx = dk = db = None
        if ctx.needs_input_grad[2]:
            db = dpre.sum(dim=(0, 1)).to(ctx.bias_dtype)
        dpre = dpre.to(x.dtype)
        if ctx.needs_input_grad[0]:
            dx = pos_conv_dx(dpre, kernel, groups=ctx.groups)
        if ctx.needs_input_grad[1]:
            dk = pos_conv_dw(x, dpre, kernel.shape[0], groups=ctx.groups).to(kernel.dtype)
        return dx, dk, db, None, None
