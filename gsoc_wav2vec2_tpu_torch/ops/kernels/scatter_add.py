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

The kernel is deterministic: two launches on the same inputs are bit-equal
(fixed segments, each split in a fixed way among warp groups that sum in
source order; the groups' and then the segments' partial tiles added in
order; no float atomics).  An index outside [0, l_rows) is dropped by the
kernel (it is never written out of bounds); the plain version raises on it.
Checking on the host would cost a device synchronisation, so the wrapper
does not.
"""

from __future__ import annotations

import torch

from . import _build

# sources per segment (the kernel takes multiples of 512 up to 4096): more
# segments spread a hot destination row over more blocks and cost one
# (l_rows, D) f32 partial tile each
SEGMENT = 4096
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
    dneg, idx_local = dneg.contiguous(), idx_local.contiguous()
    segments = -(-n // SEGMENT)
    out = torch.empty((b, l_rows, d), dtype=torch.float32, device=dneg.device)
    part = out if segments == 1 else torch.empty(
        (b, segments, l_rows, d), dtype=torch.float32, device=dneg.device)
    lib = _build.library()
    _build.check("scatter_rows_add", lib.w2v2_scatter_rows_add(
        dneg.data_ptr(), idx_local.data_ptr(), part.data_ptr(), out.data_ptr(), b, n, d, l_rows,
        SEGMENT, int(dneg.dtype == torch.bfloat16), _build.stream_of(dneg)))
    scatter_rows_add.launches += 1
    return out


scatter_rows_add.launches = 0
