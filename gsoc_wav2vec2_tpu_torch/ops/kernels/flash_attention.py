"""Flash attention, head dims 64, 128, 192 and 256 in bf16
(`csrc/flash_attention.cu`) and in f32 (`csrc/flash_attention_f32.cu` at 64,
`csrc/flash_attention_f32_wide.cu` at 128-256): forward with in-kernel prob
dropout, backward, and the `torch.autograd.Function` over both.

Counterpart of `gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py`
(`_flash_fwd`, `_flash_bwd` and the custom VJP `_flash_attention_core`):
softmax(q k^T + key_bias) [-> dropout] v with q already scaled by D^-1/2,
softmax in f32, probabilities cast to the compute dtype before the product
with v; the forward also returns the row logsumexp of the undropped softmax,
from which the backward recomputes p.  The key bias is (B, L) f32 (0 / -10000
from `mask_to_bias`); the kernels mask the ragged edge themselves, so L
needs no padding.  q, k, v may be strided views (the heads split out of the
projections); the kernels read them in place through TMA tensor maps
(`tma_layout`), which take a 16-byte-aligned base and 16-byte byte strides;
a view that breaks those rules is copied first.  In f32 everything stays
f32, as in JAX's kernel run on f32 inputs (p is not rounded): each product
is three TF32 products on the tensor cores, ~2^-22 of f32 off.

Dropout is the JAX kernel's counter hash (`dropout_mask`): the keep bit of
element (b, h, row, col) hashes seed + b*H + h and row * Lp + col, with Lp =
L rounded up to 128 (the JAX wrapper pads L to Lp before its kernel).  The
same bits come back in the backward, so no mask is ever stored.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..basic import _i32, _shr, below_threshold, keep_threshold
from . import _build

# the head dims the kernels are instantiated at (`csrc/flash_attention.cu`);
# JAX's kernel takes every multiple of 64, but from 320 on the output
# accumulator alone (D / 2 f32 a consumer thread: 160) leaves too few of the
# 240 registers a consumer warpgroup has, so those run the plain attention
HEAD_DIMS = (64, 128, 192, 256)
# the dtypes the kernels take, each at every head dim, and their C entry
# points (forward, backward); f32 past head dim 64 adds `_wide`
# (`csrc/flash_attention_f32.cu` at 64, `csrc/flash_attention_f32_wide.cu`)
_ENTRY = {torch.bfloat16: ("w2v2_flash_fwd", "w2v2_flash_bwd"),
          torch.float32: ("w2v2_flash_fwd_f32", "w2v2_flash_bwd_f32")}
# one TMA box row is one 128-byte swizzle row: 64 bf16 or 32 f32 columns
BOX_BYTES = 128


def _entry(dtype: torch.dtype, head_dim: int, backward: bool):
    """The C entry point of the kernels for `dtype` at `head_dim`."""
    name = _ENTRY[dtype][backward]
    wide = dtype == torch.float32 and head_dim > 64
    return getattr(_build.library(), name + "_wide" if wide else name)


def _mix_seed(seed) -> torch.Tensor:
    """(seed as uint32) * 2654435761, wrapped to 32 bits, as int32 bits."""
    s = torch.as_tensor(seed, dtype=torch.int64)
    s = (s & 0xFFFFFFFF) * 2654435761 & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def dropout_mask(shape, rate: float, seed, row_offset: int = 0, col_offset: int = 0,
                 row_stride: Optional[int] = None, device=None) -> torch.Tensor:
    """Bool keep-mask of `shape` (rows, cols), bit for bit JAX's
    `_dropout_mask`.  `seed` is an int or an integer tensor that broadcasts
    against the mask from the left (e.g. (B, H, 1, 1) per-head seeds); the
    arithmetic is uint32 with wraparound, carried in int32 bit patterns."""
    rows, cols = shape
    stride = cols if row_stride is None else row_stride
    r = torch.arange(rows, dtype=torch.int64, device=device) + row_offset
    c = torch.arange(cols, dtype=torch.int64, device=device) + col_offset
    idx = (r[:, None] * stride + c[None, :]) & 0xFFFFFFFF
    x = torch.where(idx >= 2**31, idx - 2**32, idx).to(torch.int32)
    mix = _mix_seed(seed).to(x.device)
    x = torch.bitwise_xor(x, mix).mul_(_i32(0x7FEB352D))
    x = x.bitwise_xor_(_shr(x, 15)).mul_(_i32(0x846CA68B))
    return below_threshold(x, rate)


def padded_length(l: int) -> int:
    """The hash's row stride: L rounded up to a multiple of 128."""
    return -(-l // 128) * 128


def _head_seeds(seed: int, b: int, h: int, device) -> torch.Tensor:
    """seed + b*H + h, one per (batch, head): the kernel's flat grid index."""
    return (seed + torch.arange(b * h, dtype=torch.int64, device=device)).reshape(b, h, 1, 1)


def _acc(q) -> torch.dtype:
    """The plain versions' accumulation dtype: f32, f64 for f64 inputs."""
    return torch.promote_types(q.dtype, torch.float32)


def _scores(q, k, bias):
    acc = _acc(q)
    s = q.to(acc) @ k.to(acc).transpose(-1, -2)
    if bias is not None:
        s = s + bias.to(acc)[:, None, None, :]
    return s


def _keep(q, rate, seed):
    b, h, l, _ = q.shape
    return dropout_mask((l, l), rate, _head_seeds(seed, b, h, q.device),
                        row_stride=padded_length(l), device=q.device)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor] = None,
    *, dropout_rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, H, L, D); bias (B, L) f32 or None -> (out (B, H, L, D) in
    q's dtype, lse (B, H, L) f32; f64 throughout for f64 inputs).  Dropout as
    JAX's kernel: normalise, cast to the compute dtype, drop, scale by
    1 / (1 - rate) in that dtype."""
    acc = _acc(q)
    s = _scores(q, k, bias)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    if dropout_rate:
        p = torch.where(_keep(q, dropout_rate, seed), p / (1.0 - dropout_rate),
                        torch.zeros_like(p)).to(v.dtype)
    return (p.to(acc) @ v.to(acc)).to(q.dtype), lse


def flash_attention_bwd_plain(
    q, k, v, bias, out, lse, dout, *, dropout_rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention_fwd_plain`'s out, by recomputing
    p = exp(s - lse), with the kernel's roundings: ds and the dropped p cast
    to the compute dtype before their products.  The softmax correction is
    delta = sum_d dout * out (equal to JAX's sum_k p * dp, dropout included).
    Sums in f32, in f64 for f64 inputs."""
    acc = _acc(q)
    s = _scores(q, k, bias)
    p = torch.exp(s - lse[..., None])
    dpt = dout.to(acc) @ v.to(acc).transpose(-1, -2)
    if dropout_rate:
        keep = _keep(q, dropout_rate, seed)
        scale = 1.0 / (1.0 - dropout_rate)
        r = torch.where(keep, p * scale, torch.zeros_like(p))
        dp = torch.where(keep, dpt * scale, torch.zeros_like(dpt))
    else:
        r, dp = p, dpt
    delta = (dout.to(acc) * out.to(acc)).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).to(acc)
    dq = ds @ k.to(acc)
    dk = ds.transpose(-1, -2) @ q.to(acc)
    dv = r.to(v.dtype).to(acc).transpose(-1, -2) @ dout.to(acc)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def supports(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the flash kernels take heads of `head_dim` in `dtype`: 64,
    128, 192 or 256 in bf16 or f32 (the JAX kernel takes every multiple of
    64 in either).  Elsewhere the card runs `flash_attention_fwd_plain`
    through autograd, with the same hash dropout."""
    return head_dim in HEAD_DIMS and dtype in _ENTRY


def _check(name, q, k, v, bias):
    b, h, l, d = q.shape
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"{name} takes bf16 or f32 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not supports(d, q.dtype):
        raise ValueError(f"{name} takes head dims {HEAD_DIMS}, got {d}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, H, L, D) shape")
    st = q.stride()
    if (not (st == k.stride() == v.stride()) or not _layout_ok(tuple(q.shape), st, q.element_size())
            or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        q, k, v = _dense(q), _dense(k), _dense(v)
    if bias is not None:
        if tuple(bias.shape) != (b, l):
            raise ValueError(f"{name}: bias must be (B, L), got {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    return q, k, v, bias


def tma_layout(shape, strides, esize: int = 2):
    """The 4-D tensor map the kernels read a (B, H, L, D) tensor of
    `esize`-byte elements through, as `encode_bhld` in
    `csrc/flash_attention.cuh` builds it from the element strides (sb, sh,
    sl, 1): dims innermost first, (D, L, H, B), or (D, H, L, B) when sh < sl
    (the heads of a row side by side, as in the (B, L, H*D) projections), so
    that the strides ascend; a dimension of size 1 gets the packed stride.
    Returns (dims, byte strides of dims 1-3, box, heads_inner); the box is 64
    rows (32 for f32 past head dim 64: those kernels stream 32-row tiles to
    fit their shared memory) of one 128-byte swizzle row (64 bf16 or 32 f32
    elements), D x esize / 128 boxes a row of D."""
    b, h, l, d = shape
    sb, sh, sl = strides[:3]
    heads_inner = sh < sl
    dims = [d, h, l, b] if heads_inner else [d, l, h, b]
    st = [sh, sl, sb] if heads_inner else [sl, sh, sb]
    span = d
    for i in range(3):
        if dims[i + 1] == 1:
            st[i] = span
        span = st[i] * dims[i + 1]
    cols, rows = BOX_BYTES // esize, 32 if esize == 4 and d > 64 else 64
    box = [cols, 1, rows, 1] if heads_inner else [cols, rows, 1, 1]
    return dims, [esize * s for s in st], box, heads_inner


def _strided_ok(x: torch.Tensor) -> bool:
    """What TMA reads in place: rows of D contiguous elements (D in
    `HEAD_DIMS`) at a 16-byte-aligned base, byte strides that are multiples
    of 16 below 2^40, and nested (non-overlapping) dimensions in the
    `tma_layout` order."""
    return x.data_ptr() % 16 == 0 and _layout_ok(tuple(x.shape), x.stride(), x.element_size())


@functools.lru_cache(maxsize=256)
def _layout_ok(shape, strides, esize: int = 2) -> bool:
    if len(shape) != 4 or shape[-1] not in HEAD_DIMS or strides[-1] != 1:
        return False
    dims, byte_strides, _, _ = tma_layout(shape, strides, esize)
    if any(s % 16 or s >= 2**40 for s in byte_strides):
        return False
    spans = [dims[0] * esize] + [s * n for s, n in zip(byte_strides, dims[1:])]
    return all(s >= span for s, span in zip(byte_strides, spans))


def _dense(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy where `x` breaks a TMA rule (a contiguous view at
    a misaligned offset copies too: `contiguous` would return it as it is)."""
    if _strided_ok(x) and x.is_contiguous():
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")


def _dropout_args(l: int, rate: float):
    return keep_threshold(rate), padded_length(l), 1.0 / (1.0 - rate), int(rate > 0.0)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor] = None,
    *, dropout_rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of `flash_attention_fwd_plain`."""
    _check_rate(dropout_rate)
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, bias, dropout_rate=dropout_rate, seed=seed)
    q, k, v, bias = _check("flash_attention_fwd", q, k, v, bias)
    b, h, l, d = q.shape
    threshold, stride, inv_keep, drop = _dropout_args(l, dropout_rate)
    # written (B, L, H, D); returned as the (B, H, L, D) view
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    sb, sh, sl = q.stride()[:3]
    _build.check("flash_attention_fwd", _entry(q.dtype, d, False)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b * h, h, l, d, sb, sh, sl,
        int(seed), threshold, stride, inv_keep, drop, _build.stream_of(q)))
    flash_attention_fwd.launches += 1
    return out.transpose(1, 2), lse


flash_attention_fwd.launches = 0


@torch.library.custom_op("w2v2::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor], dropout_rate: float,
                           seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_fwd` as a `torch.library` operator, which
    `torch.export` keeps in its graph (the kernel for CUDA tensors, the
    plain version for CPU ones)."""
    return flash_attention_fwd(q, k, v, bias, dropout_rate=dropout_rate, seed=seed)


@flash_attention_fwd_op.register_fake
def _(q, k, v, bias, dropout_rate, seed):
    b, h, l, d = q.shape
    # the kernel writes (B, L, H, D) and returns its (B, H, L, D) view
    out = (q.new_empty((b, l, h, d)).transpose(1, 2) if q.device.type == "cuda"
           else q.new_empty((b, h, l, d)))
    return out, q.new_empty((b, h, l), dtype=torch.float32)


def flash_attention_bwd(
    q, k, v, bias, out, lse, dout, *, dropout_rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper of `flash_attention_bwd_plain` (three launches: the
    row deltas, dk/dv, dq).  dq, dk, dv come back as (B, H, L, D) views of
    (B, L, H, D) tensors, the layout the head split's autograd wants."""
    _check_rate(dropout_rate)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                         dropout_rate=dropout_rate, seed=seed)
    q, k, v, bias = _check("flash_attention_bwd", q, k, v, bias)
    b, h, l, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, l):
        raise ValueError("flash_attention_bwd: out, dout (B, H, L, D) and lse (B, H, L) expected")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd takes out and dout in q's dtype and f32 lse")
    out = out if _strided_ok(out) else _dense(out)
    dout = dout if _strided_ok(dout) else _dense(dout)
    lse = lse.contiguous()
    threshold, stride, inv_keep, drop = _dropout_args(l, dropout_rate)
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, l, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    _build.check("flash_attention_bwd", _entry(q.dtype, d, True)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dout.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, h, l, d,
        *q.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
        int(seed), threshold, stride, inv_keep, drop, _build.stream_of(q)))
    flash_attention_bwd.launches += 1
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of JAX's custom VJP).
    The forward saves q, k, v, the bias, out and lse; the backward is the
    kernel for CUDA tensors and the plain version for CPU ones.  The bias
    (a mask constant) and the seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, dropout_rate: float, seed: int):
        out, lse = flash_attention_fwd(q, k, v, bias, dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.dropout_rate, ctx.seed = dropout_rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, dout,
                                         dropout_rate=ctx.dropout_rate, seed=ctx.seed)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, bias=None, *, dropout_rate: float = 0.0, seed: int = 0):
    """Differentiable attention output (B, H, L, D) through `FlashAttention`."""
    return FlashAttention.apply(q, k, v, bias, float(dropout_rate), int(seed))
