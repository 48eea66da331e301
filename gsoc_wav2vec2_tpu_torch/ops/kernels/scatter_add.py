"""Row scatter-add (`csrc/scatter_add.cu`): the backward of the contrastive
loss's negatives gather.

Counterpart of `gsoc_wav2vec2_tpu/ops/pallas/scatter_add.py`:

    out[b, j, :] = sum over n with idx_local[b, n] == j of dneg[b, n, :]

with dneg (B, N, D) f32 or bf16, idx_local (B, N) int32 destination rows in
[0, l_rows) and out (B, l_rows, D) f32.  The indices are local to each batch
row (negatives are drawn within one utterance).

Addends: every addend enters the f32 sum exactly, as in the XLA scatter the
JAX package keeps on the CPU.  The TPU kernel rounds each addend to bf16 for
its matrix unit; the CUDA kernel has no matrix product and does not.  So an
f32 cotangent agrees with `.at[].add` to f32 summation order and with the
TPU kernel to bf16 rounding of the addends; a bf16 cotangent agrees with
both to summation order.

The kernel sorts, then sums: a stable counting sort of each batch row's
indices (`scatter_plan` is its result in plain torch), then the listed
sources of all rows cut into `shares` contiguous shares (`share_bounds`),
each summed in list order by one block, a row split across shares added in
share order (`scatter_rows_add_by_shares` is that partition in plain
torch).  So it is
deterministic: two launches on the same inputs are bit-equal (no float
atomics).  An index outside [0, l_rows) is dropped by the kernel (it is never
written out of bounds); the plain version raises on it.  Checking on the
host would cost a device synchronisation, so the wrapper does not.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

SHARES_PER_SM = 2     # blocks of the sum kernel an SM holds at once
COL_BLOCK = 1024      # columns a block of the sum kernel sums
SMEM_HIST_ROWS = 1536  # the plan keeps its histograms in shared memory up to here
PLAN_CLUSTER = 8      # blocks of a batch row's plan
PLAN_WARPS = 256      # warps of a batch row's plan (8 blocks of 32), each a contiguous part of the sources
_FLOATS = (torch.float32, torch.bfloat16)


def supports(l_rows: int, d: int) -> bool:
    """What the CUDA kernel takes: any positive row count and width whose
    (l_rows, d) tile is indexable in int32."""
    return l_rows >= 1 and d >= 1 and l_rows * d < 2**31


def scatter_rows_add_plain(dneg: torch.Tensor, idx_local: torch.Tensor, *,
                           l_rows: int) -> torch.Tensor:
    """Same function as the kernel: f32 addends into an f32 sum
    (one `index_add_` per batch row, which checks the index range)."""
    b, _, d = dneg.shape
    out = torch.zeros((b, l_rows, d), dtype=torch.float32, device=dneg.device)
    for i in range(b):
        out[i].index_add_(0, idx_local[i].long(), dneg[i].float())
    return out


def scatter_plan(idx_local: torch.Tensor, l_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan kernel's counting sort in plain torch, step by step as the
    kernel takes it: warp w of 256 (a cluster of 8 blocks of 32, in rank
    order) owns sources [w per, (w + 1) per) (per = N / 256 rounded up to
    32) and walks them 32 at a time; (warp, key) gets its first slot from
    the histograms scanned warp by warp within a key, then over keys; a
    source lands at that slot plus its rank among the equal keys of lower
    lanes and earlier steps.  Returns per batch row
    `order` (N,): the listed sources (indices in [0, l_rows)) by
    destination, then -1 where the dropped ones would be; and `start` (B,
    l_rows + 1): where each destination's sources begin (start[:, l_rows]
    = the row's listed count)."""
    b, n = idx_local.shape
    dev = idx_local.device
    per = -(-n // PLAN_WARPS)
    per = -(-per // 32) * 32
    steps = per // 32
    key = torch.full((b, PLAN_WARPS * per), -1, dtype=torch.int64, device=dev)
    key[:, :n] = idx_local.long()
    key[(key < 0) | (key >= l_rows)] = -1
    key = key.reshape(b, PLAN_WARPS, steps, 32)
    onehot = torch.nn.functional.one_hot(key + 1, l_rows + 1)[..., 1:]  # (B, W, steps, 32, L)
    hist = onehot.sum(dim=(2, 3))  # (B, W, L)
    start = torch.zeros((b, l_rows + 1), dtype=torch.int64, device=dev)
    start[:, 1:] = torch.cumsum(hist.sum(dim=1), dim=1)
    slot = start[:, None, :-1] + torch.cumsum(hist, dim=1) - hist  # (B, W, L)
    # rank of each source among its warp's equal keys before it (earlier
    # steps, then lower lanes of its step)
    seen = torch.cumsum(onehot.reshape(b, PLAN_WARPS, steps * 32, l_rows), dim=2) - onehot.reshape(
        b, PLAN_WARPS, steps * 32, l_rows)
    k = key.reshape(b, PLAN_WARPS, steps * 32)
    listed = k >= 0
    kc = k.clamp_min(0)
    pos = (torch.gather(slot, 2, kc) + torch.gather(seen, 3, kc[..., None])[..., 0])
    order = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    src = torch.arange(PLAN_WARPS * per, device=dev).reshape(PLAN_WARPS, steps * 32)
    for i in range(b):
        order[i, pos[i][listed[i]]] = src[listed[i]]
    return order, start


def share_bounds(total: int, shares: int) -> list:
    """[(g0, g1)] of the sum kernel's blocks over `total` listed sources:
    contiguous shares that differ by at most one source (p total / shares
    to (p + 1) total / shares)."""
    return [(p * total // shares, (p + 1) * total // shares) for p in range(shares)]


def scatter_rows_add_by_shares(dneg: torch.Tensor, idx_local: torch.Tensor, *, l_rows: int,
                               shares: int) -> torch.Tensor:
    """The sum kernel's partition in plain torch, in its order of f32 sums:
    the listed sources of all rows, batch row after batch row, cut into
    `shares` shares (`share_bounds`); each share adds its runs (sources of
    one row) in list order; a run inside the share is the row's result, a run cut by a
    share boundary is a piece, and a row's pieces are added in share order.
    Rows with no source are zero.  (A reference for the kernel's
    arithmetic, one source at a time: slow, for small inputs.)"""
    b, _, d = dneg.shape
    order, start = scatter_plan(idx_local, l_rows)
    rows, src = [], []  # the list: (global row, source) pairs
    for i in range(b):
        for j in range(l_rows):
            for p in range(int(start[i, j]), int(start[i, j + 1])):
                rows.append(i * l_rows + j)
                src.append((i, int(order[i, p])))
    out = torch.zeros((b * l_rows, d), dtype=torch.float32, device=dneg.device)
    pieces = {}  # row -> its pieces in share order
    for g0, g1 in share_bounds(len(rows), shares):
        g = g0
        while g < g1:
            r, acc = rows[g], torch.zeros(d, dtype=torch.float32, device=dneg.device)
            while g < g1 and rows[g] == r:
                acc += dneg[src[g]].float()
                g += 1
            pieces.setdefault(r, []).append(acc)
    for r, parts in pieces.items():
        acc = parts[0]
        for piece in parts[1:]:
            acc = acc + piece
        out[r] = acc
    return out.reshape(b, l_rows, d)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scatter_rows_add(dneg: torch.Tensor, idx_local: torch.Tensor, *, l_rows: int) -> torch.Tensor:
    """Kernel wrapper of `scatter_rows_add_plain`: (B, N, D) f32 or bf16 and
    (B, N) int32 -> (B, l_rows, D) f32."""
    if dneg.dim() != 3 or idx_local.shape != dneg.shape[:2]:
        raise ValueError(
            f"scatter_rows_add takes dneg (B, N, D) and indices (B, N), got "
            f"{tuple(dneg.shape)} and {tuple(idx_local.shape)}")
    if not dneg.is_cuda:
        return scatter_rows_add_plain(dneg, idx_local, l_rows=l_rows)
    b, n, d = dneg.shape
    if dneg.dtype not in _FLOATS or idx_local.dtype != torch.int32:
        raise ValueError(
            f"scatter_rows_add takes f32 or bf16 rows and int32 indices, got {dneg.dtype} "
            f"and {idx_local.dtype}")
    if not supports(l_rows, d) or idx_local.device != dneg.device or b * n == 0:
        raise ValueError(f"scatter_rows_add: unsupported shape {tuple(dneg.shape)} -> {l_rows} rows")
    dev = dneg.device
    # the bulk copies take rows of a multiple of 16 bytes on 16-byte addresses
    per16 = 16 // dneg.element_size()
    ld = -(-d // per16) * per16
    dneg = dneg.contiguous() if ld == d else F.pad(dneg, (0, ld - d))
    if dneg.data_ptr() % 16:
        dneg = dneg.clone()
    idx_local = idx_local.contiguous()
    col_blocks = -(-d // COL_BLOCK)
    shares = max(1, SHARES_PER_SM * _sm_count(dev.index if dev.index is not None else
                                               torch.cuda.current_device()) // col_blocks)
    order = torch.empty((b, n, 2), dtype=torch.int32, device=dev)  # (source, row) pairs
    ints = torch.empty(b * (l_rows + 1) + 1, dtype=torch.int32, device=dev)
    start, ticket = ints[:-1], ints[-1:]
    work = (torch.empty(b * PLAN_CLUSTER * (34 * l_rows + 1), dtype=torch.int32, device=dev)
            if l_rows > SMEM_HIST_ROWS else None)
    longs = torch.empty(b + 1 + 2 * shares, dtype=torch.int64, device=dev)
    part = torch.empty((shares, 2, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, l_rows, d), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.check("scatter_rows_add", lib.w2v2_scatter_rows_add(
        dneg.data_ptr(), idx_local.data_ptr(), order.data_ptr(), start.data_ptr(),
        longs.data_ptr(), ticket.data_ptr(),
        work.data_ptr() if work is not None else None, part.data_ptr(),
        longs[b + 1:].data_ptr(), out.data_ptr(), b, n, d, ld, l_rows, shares,
        int(dneg.dtype == torch.bfloat16), _build.stream_of(dneg)))
    scatter_rows_add.launches += 1
    return out


scatter_rows_add.launches = 0
