"""Flash attention forward, head dim 64 (`csrc/flash_attention.cu`).

Counterpart of `gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py::_flash_fwd`:
softmax(q k^T + key_bias) v with q already scaled by D^-1/2, softmax in f32,
probabilities cast to the compute dtype before the product with v; returns
the output and the row logsumexp (kept for the backward of a later slice).
The key bias is (B, L) f32 (0 / -10000 from `mask_to_bias`); the kernel masks
the ragged edge itself, so L needs no padding.  q, k, v may be strided views
(the heads split out of the projections); the kernel reads them in place.  Prob dropout is not in this
slice: a rate other than 0 raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, H, L, D); bias (B, L) f32 or None -> (out (B, H, L, D) in
    q's dtype, lse (B, H, L) f32)."""
    s = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype), lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor] = None,
    *, dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of `flash_attention_fwd_plain`."""
    if dropout_rate != 0.0:
        raise NotImplementedError(
            "attention-prob dropout arrives with the flash backward; inference passes 0"
        )
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, bias)
    b, h, l, d = q.shape
    if d != 64:
        raise ValueError(f"flash_attention_fwd takes head dim 64, got {d}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"flash_attention_fwd takes bf16 q, k, v, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention_fwd: q, k, v must share one (B, H, L, D) shape")
    if not (q.stride() == k.stride() == v.stride()) or q.stride(-1) != 1 or any(
        st % 8 for st in q.stride()[:3]
    ):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bias is not None:
        if tuple(bias.shape) != (b, l):
            raise ValueError(f"flash_attention_fwd: bias must be (B, L), got {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    # written (B, L, H, D); returned as the (B, H, L, D) view
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    sb, sh, sl = q.stride()[:3]
    lib = _build.library()
    _build.check("flash_attention_fwd", lib.w2v2_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b * h, h, l, d, sb, sh, sl, _build.stream_of(q)))
    flash_attention_fwd.launches += 1
    return out.transpose(1, 2), lse


flash_attention_fwd.launches = 0
