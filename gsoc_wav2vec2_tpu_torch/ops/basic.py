"""Elementary building blocks (counterpart of `gsoc_wav2vec2_tpu/ops/basic.py`).

Normalisation statistics and the norm affine always run in float32 and the
result is cast back to the input dtype, so bfloat16 forwards stay stable.
Dropout is JAX's counter-hash dropout (`_hash_keep_mask`), bit for bit for
the same two seed words; JAX draws the words from its key, the port from an
explicit `torch.Generator` (`seed_words`).  Stochastic depth draws one
Bernoulli per batch and does not rescale at eval.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

SeedWords = Tuple[int, int]

# uint32 arithmetic with wraparound, carried in int32 bit patterns (torch's
# uint32 has no CPU arange and few ops): multiplication and xor wrap alike,
# a right shift must be made logical, and an unsigned compare flips the sign
# bit of both sides.
_INT32_MIN = -(2**31)


def _i32(v: int) -> int:
    """A uint32 value (any Python int, wrapped) as the int32 with its bits."""
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns (torch's is arithmetic)."""
    return torch.bitwise_right_shift(x, s).bitwise_and_((1 << (32 - s)) - 1)


def keep_threshold(rate: float) -> int:
    """Keep while the hash is below this uint32 (computed in double, as JAX)."""
    return int((1.0 - rate) * float(2**32 - 1))


def below_threshold(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Unsigned x < keep_threshold(rate), on int32 bit patterns (in place on x)."""
    return x.bitwise_xor_(_INT32_MIN) < _i32(keep_threshold(rate) ^ 0x80000000)


def seed_words(generator: torch.Generator) -> SeedWords:
    """Two uint32 words from `generator` (JAX: `jax.random.bits(rng, (2,),
    uint32)`): the seed of one dropout mask."""
    w = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64)
    return int(w[0]), int(w[1])


def murmur_mix(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finaliser on int32 bit patterns (uint32 arithmetic with
    wraparound); updates `x` in place and returns it."""
    x.bitwise_xor_(_shr(x, 16)).mul_(_i32(0x7FEB352D))
    x.bitwise_xor_(_shr(x, 15)).mul_(_i32(0x846CA68B))
    return x.bitwise_xor_(_shr(x, 16))


def _element_index(shape, device, span=None) -> torch.Tensor:
    """int32 bit patterns of each element's uint32 row-major index: in
    `shape` itself, or, with `span = (offsets, full_shape)`, of the block
    of `shape` at `offsets` in a tensor of `full_shape` (a rank's rows or
    columns of the global tensor).  The index wraps at 2**32, as in JAX."""
    if span is None:
        n = 1
        for s in shape:
            n *= s
        if n < 2**31:
            return torch.arange(n, dtype=torch.int32, device=device).reshape(shape)
        idx = torch.arange(n, dtype=torch.int64, device=device) & 0xFFFFFFFF
        return torch.where(idx >= 2**31, idx - 2**32, idx).to(torch.int32).reshape(shape)
    offsets, full = span
    # all but the last axis in int64 (a small grid), wrapped; the last added in int32
    lead = torch.zeros((), dtype=torch.int64, device=device)
    for n, off, total in zip(shape[:-1], offsets[:-1], full[:-1]):
        lead = lead[..., None] * total + (torch.arange(n, dtype=torch.int64, device=device) + off)
    lead = (lead * full[-1]) & 0xFFFFFFFF
    lead = torch.where(lead >= 2**31, lead - 2**32, lead).to(torch.int32)
    last = torch.arange(shape[-1], dtype=torch.int32, device=device) + offsets[-1]
    return lead[..., None] + last  # int32 addition wraps like uint32


def _hash_keep_mask(seed: SeedWords, shape, rate: float, device=None, span=None) -> torch.Tensor:
    """Bool keep-mask of `shape`: `murmur_mix` of the row-major element index
    and both seed words, bit for bit JAX's `_hash_keep_mask`.  With `span`
    (`_element_index`) the mask is that block of the whole tensor's mask, so
    a rank draws its rows (and columns) of the one-process mask."""
    idx = _element_index(tuple(shape), device, span).reshape(-1)
    x = murmur_mix(idx.bitwise_xor_(_i32(seed[0] * 2654435761)))
    x = murmur_mix(x.bitwise_xor_(_i32(seed[1])))
    return below_threshold(x, rate).reshape(shape)


def dropout(x: torch.Tensor, rate: float, seed: Optional[SeedWords],
            deterministic: bool, span=None) -> torch.Tensor:
    """Inverted dropout with the hash mask of `seed` (two uint32 words);
    `span` places `x` in the whole tensor (`_element_index`)."""
    if deterministic or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("dropout requires seed words when not deterministic")
    keep = _hash_keep_mask(seed, x.shape, rate, device=x.device, span=span)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def stochastic_depth(residual: torch.Tensor, branch: torch.Tensor, survival_prob: float,
                     keep: Optional[bool], deterministic: bool) -> torch.Tensor:
    """Residual + branch, the branch kept with probability `survival_prob`
    in training (`keep`: one Bernoulli draw for the whole batch); at eval
    the sum is not rescaled (reference `tensorflow_addons.py:386-390`)."""
    if deterministic or survival_prob >= 1.0:
        return residual + branch
    if keep is None:
        raise ValueError("stochastic_depth requires a draw when training")
    return residual + (branch if keep else torch.zeros_like(branch))


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU matching `jax.nn.gelu`.  Exact (erf) GELU becomes the tanh form
    in bfloat16, as in the JAX package (`ops/basic.py:31-32`): below bf16
    resolution the two agree and tanh is the cheaper one."""
    if approximate or x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`y = x @ kernel + bias` with a kernel of shape (in, out), cast to the
    activation dtype at use.  The bias rides in the product's epilogue
    (`addmm`): one rounding to the activation dtype instead of two."""
    kernel = kernel.to(x.dtype)
    if bias is None:
        return x @ kernel
    y = torch.addmm(bias.to(x.dtype), x.reshape(-1, x.shape[-1]), kernel)
    return y.reshape(*x.shape[:-1], kernel.shape[-1])


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis: population variance, eps inside the
    sqrt, statistics and affine in float32.  As every kernel site of the
    port: on the card the fast call, one fused `F.layer_norm`; on the CPU
    its plain version, `layer_norm_plain`, which the JAX-parity tests hold.
    The fused call folds the statistics into one scale and shift, so it
    rounds differently in the last bit; on the card it is held against
    `layer_norm_plain` (`tests/test_torch_cuda.py`, `chip_smoke.py` phase
    6b, which also times both)."""
    if not x.is_cuda:
        return layer_norm_plain(x, gamma, beta, eps)
    return F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(), eps).to(x.dtype)


def layer_norm_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """The JAX package's LayerNorm, operation for operation: the mean, the
    mean square about it, then `(x - mean) * rsqrt(var + eps) * gamma +
    beta`, in float32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def group_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over a channels-last (B, T, C) tensor: each group's
    statistics run over (T, C // groups), in float32."""
    y = F.group_norm(x.float().transpose(1, 2), groups, gamma.float(), beta.float(), eps)
    return y.transpose(1, 2).to(x.dtype)
