"""Multi-head self-attention (counterpart of `gsoc_wav2vec2_tpu/ops/attention.py`).

Separate q/k/v/out projections, q scaled by `head_size ** -0.5`, an additive
key bias on the raw scores, softmax in float32 and probabilities cast to the
compute dtype before the product with v, prob dropout in training.  `mha`
runs the core through `ops/kernels/flash_attention.py` (forward and
backward): the hand-written kernels for a CUDA tensor, their plain versions
on the CPU.  `mha_plain` is the full-materialisation
formulation (the counterpart of JAX's `mha_xla`) the tests hold it against.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.partition import copy_to_model, row_parallel_dense
from .basic import dense
from .kernels import flash_attention as flash


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H) -> (B, num_heads, L, head_size)."""
    b, l, h = x.shape
    return x.reshape(b, l, num_heads, h // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, num_heads, L, head_size) -> (B, L, H)."""
    b, n, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, n * d)


def _project_qkv(x, params, num_heads):
    # from the projection's width: under a model axis x is whole, the kernel a shard
    head_size = params.q_proj.kernel.shape[-1] // num_heads
    q = split_heads(dense(x, params.q_proj.kernel, params.q_proj.bias), num_heads)
    k = split_heads(dense(x, params.k_proj.kernel, params.k_proj.bias), num_heads)
    v = split_heads(dense(x, params.v_proj.kernel, params.v_proj.bias), num_heads)
    return q * head_size ** -0.5, k, v


def mha_plain(
    x: torch.Tensor, params, num_heads: int, mask_bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Full-materialisation attention (counterpart of `mha_xla`).

    `mask_bias` is an additive float bias broadcastable to
    (B, num_heads, L, L), typically (B, 1, 1, L) with 0 / -10000 entries.
    """
    q, k, v = _project_qkv(x, params, num_heads)
    scores = q.float() @ k.float().transpose(-1, -2)
    if mask_bias is not None:
        scores = scores + mask_bias.float()
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    context = (probs.float() @ v.float()).to(x.dtype)
    return dense(merge_heads(context), params.out_proj.kernel, params.out_proj.bias)


def attention_seed(generator: torch.Generator) -> int:
    """The per-call seed of the in-kernel prob dropout, drawn in [0, 2**23)
    (JAX: `jax.random.randint(rng, (), 0, 2**23)`); the kernel adds the
    (batch, head) index to it."""
    return int(torch.randint(0, 2**23, (), generator=generator))


def mha(
    x: torch.Tensor, params, num_heads: int, mask_bias: Optional[torch.Tensor] = None, *,
    dropout_rate: float = 0.0, seed: Optional[int] = None, training: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Attention through the flash kernel wrappers; `mask_bias` as in
    `mha_plain`, a key bias broadcastable to (B, 1, 1, L).  In training,
    prob dropout at `dropout_rate` runs inside the kernel from `seed`
    (`attention_seed`).  When the projections need gradients the call goes
    through the `FlashAttention` autograd function (kernel backward);
    otherwise through the forward kernel alone, called as its
    `torch.library` operator (which `torch.export` keeps).  The kernels take
    heads of 64, 128, 192 and 256 in bf16 and of 64 in f32 (`--compute_dtype
    float32`); on the card, where they do not take the head dim or dtype
    (`flash.supports`), it is the kernel's plain version through autograd:
    the same hash dropout bits.

    Under a `mesh` (`parallel.Mesh`) the call is this rank's shard, as
    JAX's `shard_mapped_flash_attention`: its rows of the batch, and under a
    model axis H / model heads (the projections are split by column,
    `out_proj` by row, `parallel/partition.py`).  Whenever the mesh has more
    than one rank the dropout seed is `seed + shard * 2**20` and the kernel's
    hash index the local (row, head), as in the JAX shard."""
    if mesh is not None and mesh.model > 1:
        x = copy_to_model(x, mesh)
        num_heads //= mesh.model
    q, k, v = _project_qkv(x, params, num_heads)
    bias = None
    if mask_bias is not None:
        b, l = x.shape[0], x.shape[1]
        bias = mask_bias.float().expand(b, 1, 1, l).reshape(b, l)
    rate = dropout_rate if training else 0.0
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout in training requires a seed")
    seed = 0 if seed is None else seed
    if mesh is not None and mesh.size > 1:
        seed = seed + mesh.shard_index * 2**20
    if q.is_cuda and not flash.supports(q.shape[-1], q.dtype):
        context, _ = flash.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=rate, seed=seed)
    elif q.requires_grad:
        context = flash.flash_attention(q, k, v, bias, dropout_rate=rate, seed=seed)
    else:
        context, _ = flash.flash_attention_fwd_op(q, k, v, bias, rate, seed)
    return row_parallel_dense(merge_heads(context), params.out_proj.kernel,
                              params.out_proj.bias, mesh)


def mask_to_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Boolean frame mask (B, L) -> additive bias (B, 1, 1, L): masked
    (False) positions get -10000, the reference's bias value."""
    bias = (1.0 - attention_mask.to(dtype)) * -10000.0
    return bias[:, None, None, :]
