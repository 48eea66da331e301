"""The pos-conv kernels' walk over their operands, on the CPU.

The CUDA kernels (`gsoc_wav2vec2_tpu_torch/csrc/pos_conv.cu`) cannot run
here; these tests take the operands as the wrappers hand them over (the
kernel in its JAX layout (K, C // groups, C), cast to bf16; x and dpre as
(B, T, C)), cut them into the boxes the kernels load, contract them in the
kernels' order (forward and dx: one tap a ring slot, 16 channels a k step;
dW: a CTA's block of taps and share of the output channels over 64-step
time tiles, split as `dw_splits` says), and hold the result to the plain
versions.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv

torch.set_num_threads(2)

BOX = 64  # columns of a TMA box (128 bytes of bf16)


def _bf16(a: np.ndarray) -> torch.Tensor:
    """f32 values that bf16 holds exactly: the plain versions then compute in
    f32 what the kernels compute from bf16 operands."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float()


def _case(cg, k, b, t, seed):
    groups = 4
    c = groups * cg
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, t, c)))
    dpre = _bf16(rng.standard_normal((b, t, c)))
    kernel = _bf16(rng.standard_normal((k, cg, c)) * (1.5 / math.sqrt(k * cg)))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    return x, dpre, kernel, bias, groups


def _tap_boxes(w, tap, g, cg):
    """The TMA boxes of one tap and group: CG rows (the kernel's second axis)
    x 64 columns from the group's first, zero past C; wider than 64 (C/G =
    80), CG / 16 boxes of 16 columns each, the last ending at the group's
    last column."""
    if cg <= BOX:
        return [F.pad(w[tap], (0, BOX))[:, g * cg:g * cg + BOX]]
    return [w[tap][:, g * cg + 16 * i:g * cg + 16 * i + 16] for i in range(cg // 16)]


def _walk_forward(x, w, groups, pad, dx):
    """sum over taps s (ring slots) and k steps j of window[t + s] (channels
    16j ..) times the slot's boxes: the forward reads them MN-major (rows are
    the contraction; N = CG columns across the boxes), dx reads tap K-1-s
    K-major (rows are its outputs; k step j is columns 16j .., box j where
    the boxes are 16 columns wide)."""
    b, t, c = x.shape
    k, cg, _ = w.shape
    win = F.pad(x, (0, 0, pad, k - 1 - pad))  # rows t0 - pad .., zero outside [0, T)
    out = torch.zeros(b, t, c, dtype=torch.float64)
    for g in range(groups):
        acc = torch.zeros(b, t, cg, dtype=torch.float64)
        for s in range(k):
            boxes = [box.double() for box in _tap_boxes(w, k - 1 - s if dx else s, g, cg)]
            for j in range(cg // 16):
                a = win[:, s:s + t, g * cg + 16 * j:g * cg + 16 * j + 16].double()
                if dx:
                    bmat = (boxes[j] if len(boxes) > 1 else boxes[0][:, 16 * j:16 * j + 16]).T
                else:
                    bmat = torch.cat(boxes, dim=1)[16 * j:16 * j + 16, :cg]
                acc += a @ bmat
        out[:, :, g * cg:(g + 1) * cg] = acc
    return out


@pytest.mark.parametrize("cg,k,t", [(48, 128, 37), (64, 36, 50), (16, 8, 21), (48, 8, 5),
                                    (80, 128, 37), (80, 8, 5)])
def test_forward_walk_over_tap_boxes_is_the_plain_forward(cg, k, t):
    x, _, kernel, bias, groups = _case(cg, k, 2, t, cg + k)
    w = kernel.to(torch.bfloat16)  # what the wrappers pass
    pre = _walk_forward(x, w.float(), groups, k // 2, dx=False) + bias.double()
    _, want_pre = pos_conv.pos_conv_train_fwd_plain(x, kernel, bias, groups=groups,
                                                    gelu_approx=True)
    scale = want_pre.abs().max().item()
    assert (pre.float() - want_pre).abs().max().item() <= 1e-5 * scale
    y = torch.nn.functional.gelu(pre.float(), approximate="tanh")
    want = pos_conv.pos_conv_plain(x, kernel, bias, groups=groups, gelu_approx=True)
    assert (y - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("cg,k,t", [(48, 128, 37), (64, 36, 50), (16, 8, 21), (64, 4, 3),
                                    (80, 128, 37), (80, 8, 3)])
def test_dx_walk_over_flipped_tap_boxes_is_the_plain_dx(cg, k, t):
    """dx reads the forward's kernel with the taps flipped and each box read
    K-major: that is `dx_kernel`'s flipped, in/out-swapped kernel."""
    _, dpre, kernel, _, groups = _case(cg, k, 2, t, 3 * cg + k)
    w = kernel.to(torch.bfloat16)
    got = _walk_forward(dpre, w.float(), groups, k // 2 - 1, dx=True)
    want = pos_conv.pos_conv_dx_plain(dpre, kernel, groups=groups)
    assert (got.float() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _walk_dw(x, dpre, k, groups, splits):
    """dW as the kernel's CTAs sum it: a block of DW_CTA_TAPS taps (the last
    one ragged) and one of the DW_N_SPLIT shares of the group's output
    channels (the first CG / DW_N_SPLIT of a 64-channel dpre box from the
    share's first, zero past C) over the 64-step time tiles n = (b, t0) of
    its split, [n_all s / S, n_all (s + 1) / S), the splits added in order."""
    b, t, c = x.shape
    cg = c // groups
    taps, tt = pos_conv.DW_CTA_TAPS[cg], pos_conv.DW_TIME_TILE
    kn = cg // pos_conv.DW_N_SPLIT[cg]
    tpr = -(-t // tt)
    n_all = b * tpr
    rows = tt + taps
    # x rows t0 + tap0 - K/2 .. (the box), dpre rows t0 .. t0 + 63; zero outside
    xp = F.pad(x, (0, 0, k // 2 + tt, k + 2 * tt)).double()
    dp = F.pad(dpre, (0, BOX, 0, tt)).double()
    dw = torch.zeros(k, cg, c, dtype=torch.float64)
    for tap0 in range(0, k, taps):
        for g in range(groups):
            for o0 in range(0, cg, kn):
                parts = []
                for s in range(splits):
                    acc = torch.zeros(taps * cg, kn, dtype=torch.float64)
                    for n in range(n_all * s // splits, n_all * (s + 1) // splits):
                        bi, t0 = n // tpr, (n % tpr) * tt
                        lo = t0 + tap0 + tt  # x row t0 + tap0 - K/2 in xp
                        win = xp[bi, lo:lo + rows, g * cg:(g + 1) * cg]
                        d = dp[bi, t0:t0 + tt, g * cg + o0:g * cg + o0 + BOX][:, :kn]
                        for tl in range(taps):
                            acc[tl * cg:(tl + 1) * cg] += win[tl:tl + tt].T @ d
                    parts.append(acc)
                total = parts[0]
                for p in parts[1:]:
                    total = total + p
                n_taps = min(taps, k - tap0)
                dw[tap0:tap0 + n_taps, :, g * cg + o0:g * cg + o0 + kn] = \
                    total[:n_taps * cg].reshape(n_taps, cg, kn)
    return dw


@pytest.mark.parametrize("cg,k,b,t,splits", [(48, 24, 3, 130, 1), (64, 36, 2, 65, 3),
                                             (16, 40, 1, 200, 2), (48, 8, 2, 1, 1),
                                             (80, 24, 2, 130, 1), (80, 16, 1, 200, 3)])
def test_dw_walk_over_time_tiles_is_the_plain_dw(cg, k, b, t, splits):
    """Every (b, t) is in one time tile of one split, the x box starts at the
    tap block's shift, and ragged tap blocks and splits drop nothing."""
    x, dpre, _, _, groups = _case(cg, k, b, t, 5 * cg + t)
    got = _walk_dw(x, dpre, k, groups, splits)
    want = pos_conv.pos_conv_dw_plain(x, dpre, k, groups=groups)
    assert (got.float() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("k,cg,groups,b,t,want", [
    (128, 48, 16, 32, 768, 1),   # base training: 8 tap blocks x 16 groups fill 128 of 132 SMs
    (128, 64, 16, 8, 768, 1),    # robust/large: 256 blocks
    (128, 16, 16, 2, 300, 2),    # the narrow test geometry: 64 blocks
    (36, 64, 4, 2, 65, 4),       # 20 blocks (6 would fit), 4 time tiles
    (36, 64, 4, 1, 64, 1),       # one time tile: nothing to split
    (8, 48, 1, 3, 1000, 48),     # one block, 48 time tiles: one split a tile, up to 132
    (128, 80, 16, 8, 768, 1),    # 1280-d (the xlarge phase): 16 tap blocks x 16 groups x 2 = 512
    (8, 80, 16, 3, 129, 4),      # 16 blocks x 2 shares = 32 CTAs: 4 splits (9 time tiles)
    (24, 80, 4, 2, 65, 4),       # 3 x 4 x 2 = 24 CTAs (5 would fit), 4 time tiles
])
def test_dw_splits_fill_the_card_and_no_more(k, cg, groups, b, t, want):
    """`dw_splits` as `pos_conv_dw` calls it: 1 where the tap blocks fill the
    SMs, else as many splits as fit, never more than the time tiles."""
    got = pos_conv.dw_splits(k, cg, groups, b, t, 132)
    assert got == want
    blocks = -(-k // pos_conv.DW_CTA_TAPS[cg]) * groups * pos_conv.DW_N_SPLIT[cg]
    tiles = b * -(-t // pos_conv.DW_TIME_TILE)
    assert 1 <= got <= max(1, tiles) and (got == 1 or blocks * got <= 132)


def test_80_channel_boxes_load_exactly_the_group():
    """At C/G = 80 a tap's boxes (five of 16 columns) cover the group's 80
    columns once and nothing of the next group's, which a 64-column second
    box would load; the dW CTAs' output shares tile the group's columns."""
    cg, groups = 80, 3
    w = torch.arange(2 * cg * groups * cg, dtype=torch.float32).reshape(2, cg, groups * cg)
    for g in range(groups):
        cols = torch.cat(_tap_boxes(w, 1, g, cg), dim=1)
        assert torch.equal(cols, w[1][:, g * cg:(g + 1) * cg])
    kn = cg // pos_conv.DW_N_SPLIT[cg]
    assert pos_conv.DW_N_SPLIT[cg] * kn == cg and kn % 8 == 0 and kn <= BOX
