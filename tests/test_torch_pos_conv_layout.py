"""The pos-conv kernels' walk over their operands, on the CPU.

The CUDA kernels (`gsoc_wav2vec2_tpu_torch/csrc/pos_conv.cu`) cannot run
here; these tests take the operands as the wrappers hand them over (the
kernel in its JAX layout (K, C // groups, C), cast to bf16; x and dpre as
(B, T, C)), cut them into the boxes the kernels load, contract them in the
kernels' order (forward and dx: one tap a ring slot, 16 channels a k step;
dW: a CTA's block of taps and share of the output channels over 64-step
time tiles, split as `dw_splits` says), and hold the result to the plain
versions.  The forward / dx weights come through one 4-D map at every
width, ceil(C/G / 64) boxes of 64 columns a tap.  At C/G = 120 the
contraction is padded to 128 channels with zeros in both operands (8 k
steps), the forward's N is 120 of the 128 columns its two boxes hold, and
dW pads each tap's M rows to 128 and splits the group's output channels
over three CTAs.  At 32, 96, 112 and 128 the contraction is C/G itself; dW
splits the output channels of 96, 112 and 128 over two CTAs, and at 112
pads a tap's M rows to 128.  At the odd multiples of 8 below 128 (8 ..
104) the contraction is padded to the multiple of 16 above C/G, as at
120; dW reads 72's, 88's and 104's output channels from two 64-channel
dpre boxes, and pads 72's and 104's tap rows to 128.
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


def _tma_box(flat, dims, strides, box, coords):
    """A TMA box as `cuTensorMapEncodeTiled` describes it: `dims` and `box`
    innermost first, `strides` (in elements) of dims 1.., elements at
    coordinates outside `dims` read as zero.  Returns the box with its
    innermost dim last."""
    at = torch.meshgrid(*[c + torch.arange(n) for c, n in zip(coords, box)], indexing="ij")
    inside = torch.stack([(a >= 0) & (a < d) for a, d in zip(at, dims)]).all(0)
    offset = at[0] + sum(a * st for a, st in zip(at[1:], strides))
    out = torch.where(inside, flat[torch.where(inside, offset, 0)], torch.zeros((), dtype=flat.dtype))
    return out.permute(*reversed(range(len(box))))


def _tap_boxes(w, tap, g, cg):
    """The TMA boxes of one tap and group as `launch` encodes them at every
    width: the 4-D map (o, group, i, tap) over the kernel (K, CG, C), and
    ceil(CG / 64) boxes of tap_rows rows (i) x 64 columns (o), box j from
    column 64 j; zero past the group's CG rows and columns."""
    k, _, c = w.shape
    rows = pos_conv.tap_rows(cg)
    return [_tma_box(w.reshape(-1), (cg, c // cg, cg, k), (cg, c, cg * c), (BOX, 1, rows, 1),
                     (BOX * j, g, 0, tap))[0, :, 0] for j in range(-(-cg // BOX))]


def _window(x, g, cg, pad, k):
    """The forward's staged window of group g: rows t0 - pad .., zero outside
    [0, T), as tap_rows / 8 column chunks of 8 channels, those past the
    group's CG / 8 written as zeros."""
    b, t, _ = x.shape
    rows = pos_conv.tap_rows(cg)
    win = torch.zeros(b, t + k - 1, rows, dtype=x.dtype)
    for v in range(rows // 8):
        if v < cg // 8:
            win[:, pad:pad + t, 8 * v:8 * v + 8] = x[:, :, g * cg + 8 * v:g * cg + 8 * v + 8]
    return win


def _walk_forward(x, w, groups, pad, dx):
    """sum over taps s (ring slots) and the tap_rows / 16 k steps j of
    window[t + s] (channels 16j ..) times the slot's boxes: the forward reads
    them MN-major (rows are the contraction, k step j rows 16j ..; N = CG
    columns across the boxes), dx reads tap K-1-s K-major (N = its CG
    outputs of the box rows; k step j is columns 16 (j % 4) .. of box
    j // 4)."""
    b, t, c = x.shape
    k, cg, _ = w.shape
    out = torch.zeros(b, t, c, dtype=torch.float64)
    for g in range(groups):
        win = _window(x, g, cg, pad, k)
        acc = torch.zeros(b, t, cg, dtype=torch.float64)
        for s in range(k):
            boxes = [box.double() for box in _tap_boxes(w, k - 1 - s if dx else s, g, cg)]
            for j in range(pos_conv.tap_rows(cg) // 16):
                a = win[:, s:s + t, 16 * j:16 * j + 16].double()
                if dx:
                    col = 16 * (j % 4)
                    bmat = boxes[j // 4][:, col:col + 16].T[:, :cg]
                else:
                    bmat = torch.cat(boxes, dim=1)[16 * j:16 * j + 16, :cg]
                acc += a @ bmat
        out[:, :, g * cg:(g + 1) * cg] = acc
    return out


@pytest.mark.parametrize("cg,k,t", [(48, 128, 37), (64, 36, 50), (16, 8, 21), (48, 8, 5),
                                    (80, 128, 37), (80, 8, 5), (80, 16, 1), (120, 128, 37),
                                    (120, 4, 5), (120, 8, 1), (32, 128, 37), (32, 4, 5),
                                    (96, 128, 37), (96, 8, 1), (112, 128, 37), (112, 4, 5),
                                    (128, 128, 37), (128, 4, 5), (128, 8, 1), (8, 128, 37),
                                    (8, 8, 5), (24, 128, 37), (40, 8, 5), (56, 128, 37),
                                    (72, 128, 37), (72, 8, 1), (88, 128, 37), (104, 128, 37),
                                    (104, 4, 5)])
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
                                    (80, 128, 37), (80, 8, 3), (80, 16, 1), (120, 128, 37),
                                    (120, 8, 3), (120, 4, 1), (32, 128, 37), (32, 8, 3),
                                    (96, 128, 37), (96, 4, 1), (112, 128, 37), (112, 8, 3),
                                    (128, 128, 37), (128, 8, 3), (128, 4, 1), (8, 128, 37),
                                    (8, 8, 3), (24, 128, 37), (40, 8, 3), (56, 128, 37),
                                    (72, 128, 37), (72, 8, 1), (88, 128, 37), (104, 128, 37),
                                    (104, 4, 3)])
def test_dx_walk_over_flipped_tap_boxes_is_the_plain_dx(cg, k, t):
    """dx reads the forward's kernel with the taps flipped and each box read
    K-major: that is `dx_kernel`'s flipped, in/out-swapped kernel."""
    _, dpre, kernel, _, groups = _case(cg, k, 2, t, 3 * cg + k)
    w = kernel.to(torch.bfloat16)
    got = _walk_forward(dpre, w.float(), groups, k // 2 - 1, dx=True)
    want = pos_conv.pos_conv_dx_plain(dpre, kernel, groups=groups)
    assert (got.float() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _dw_a_rows(cg, taps):
    """(tap, channel) that each M row of a dW CTA reads, by the kernel's
    ldmatrix.trans addresses: warp w of consumer warpgroup wg, m64 tile m,
    matrix half q & 1 of its 16 rows, row e of that 8-channel matrix; a
    tap's rows padded to dw_tap_rows (padding rows read the 8 rows above)."""
    rows = pos_conv.dw_tap_rows(cg, taps)
    m_rows = taps * rows
    got = [None] * m_rows
    for wg in range(2):
        for m in range(m_rows // 128):
            for w in range(4):
                for half in range(2):
                    mrow = wg * (m_rows // 2) + m * 64 + 16 * w + 8 * half
                    i = mrow % rows
                    c = (i if i < cg else i - 8) // 8
                    for e in range(8):
                        got[mrow + e] = (mrow // rows, 8 * c + e)
    return got


def _walk_dw(x, dpre, k, groups, splits):
    """dW as the kernel's CTAs sum it: a block of `dw_taps` taps (the last
    one ragged) of dw_tap_rows M rows each (`_dw_a_rows`; rows past CG not
    stored) and one of the `dw_n_split` shares of the group's output
    channels (the first CG / dw_n_split of the 64-channel dpre boxes from
    the share's first, one box where the share is at most 64 channels, else
    two; zero past C) over the 64-step time tiles n = (b, t0) of its split,
    [n_all s / S, n_all (s + 1) / S), the splits added in order."""
    b, t, c = x.shape
    cg = c // groups
    taps, tt = pos_conv.WIDTHS[cg].dw_taps, pos_conv.DW_TIME_TILE
    kn = cg // pos_conv.WIDTHS[cg].dw_n_split
    boxes = -(-kn // BOX)
    tpr = -(-t // tt)
    n_all = b * tpr
    rows = tt + taps
    a_rows = _dw_a_rows(cg, taps)
    row_tap = torch.tensor([tap for tap, _ in a_rows])
    row_ch = torch.tensor([ch for _, ch in a_rows])
    # x rows t0 + tap0 - K/2 .. (the box; its `dw_window_cols` channels from
    # the group's first), dpre rows t0 .. t0 + 63; zero outside
    xp = F.pad(x, (0, BOX, k // 2 + tt, k + 2 * tt)).double()
    cols = max(cg, pos_conv.dw_window_cols(cg))
    dp = F.pad(dpre, (0, 2 * BOX, 0, tt)).double()
    dw = torch.zeros(k, cg, c, dtype=torch.float64)
    for tap0 in range(0, k, taps):
        for g in range(groups):
            for o0 in range(0, cg, kn):
                parts = []
                for s in range(splits):
                    acc = torch.zeros(len(a_rows), kn, dtype=torch.float64)
                    for n in range(n_all * s // splits, n_all * (s + 1) // splits):
                        bi, t0 = n // tpr, (n % tpr) * tt
                        lo = t0 + tap0 + tt  # x row t0 + tap0 - K/2 in xp
                        win = xp[bi, lo:lo + rows, g * cg:g * cg + cols]
                        d = dp[bi, t0:t0 + tt, g * cg + o0:g * cg + o0 + boxes * BOX][:, :kn]
                        # A[mrow, step] = window[tap + step, channel] of the row
                        a = win[row_tap[:, None] + torch.arange(tt)[None, :], row_ch[:, None]]
                        acc += a @ d
                    parts.append(acc)
                total = parts[0]
                for p in parts[1:]:
                    total = total + p
                # the epilogue: M row (tap, i) to dW[tap0 + tap, i], i < CG
                for mrow, (tap, _) in enumerate(a_rows):
                    i = mrow % pos_conv.dw_tap_rows(cg, taps)
                    if tap0 + tap < k and i < cg:
                        dw[tap0 + tap, i, g * cg + o0:g * cg + o0 + kn] = total[mrow]
    return dw


@pytest.mark.parametrize("cg,k,b,t,splits", [(48, 24, 3, 130, 1), (64, 36, 2, 65, 3),
                                             (16, 40, 1, 200, 2), (48, 8, 2, 1, 1),
                                             (80, 24, 2, 130, 1), (80, 16, 1, 200, 3),
                                             (120, 24, 2, 130, 1), (120, 8, 1, 200, 3),
                                             (32, 24, 2, 130, 1), (32, 40, 1, 200, 2),
                                             (96, 24, 2, 130, 1), (96, 12, 1, 200, 3),
                                             (112, 24, 2, 130, 1), (112, 8, 1, 200, 3),
                                             (128, 24, 2, 130, 1), (128, 12, 1, 200, 3),
                                             (8, 40, 3, 130, 1), (8, 16, 1, 200, 2),
                                             (24, 24, 2, 130, 1), (40, 24, 2, 130, 1),
                                             (56, 24, 2, 130, 1), (56, 12, 1, 200, 3),
                                             (72, 24, 2, 130, 1), (72, 8, 1, 200, 3),
                                             (88, 24, 2, 130, 1), (88, 12, 1, 200, 3),
                                             (104, 24, 2, 130, 1), (104, 8, 1, 200, 3)])
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
    (128, 120, 16, 8, 768, 1),   # 1920-d (XLS-R 2B): 22 tap blocks x 16 groups x 3 = 1056
    (4, 120, 16, 3, 129, 2),     # 1 x 16 x 3 = 48 CTAs: 2 splits
    (24, 120, 4, 2, 65, 2),      # 4 x 4 x 3 = 48 CTAs: 2 splits of the 4 time tiles
    (128, 32, 16, 8, 768, 1),    # 512 channels: 8 tap blocks x 16 groups = 128
    (128, 96, 16, 8, 768, 1),    # base widths in 8 groups / 1536 in 16: 16 x 16 x 2 = 512
    (128, 96, 8, 8, 768, 1),     # base_g8 (768-d, 8 groups): 16 x 8 x 2 = 256
    (128, 112, 16, 8, 768, 1),   # 1792 channels: 32 x 16 x 2 = 1024
    (128, 128, 16, 8, 768, 1),   # 2048 channels: 32 x 16 x 2 = 1024
    (128, 128, 8, 8, 768, 1),    # robust_g8 (1024-d, 8 groups): 32 x 8 x 2 = 512
    (16, 32, 4, 2, 300, 10),     # 1 x 4 = 4 CTAs: 33 would fit, 10 time tiles
    (4, 128, 4, 3, 129, 9),      # 1 x 4 x 2 = 8 CTAs: 16 would fit, 9 time tiles
    (128, 24, 32, 8, 768, 1),    # base_g32 (768-d, 32 groups): 8 tap blocks x 32 = 256
    (128, 8, 128, 8, 768, 1),    # robust_g128 (1024-d, 128 groups): 8 x 128 = 1024
    (128, 72, 16, 8, 768, 1),    # 1152 channels: 32 x 16 = 512
    (128, 104, 16, 8, 768, 1),   # 1664 channels: 43 x 16 = 688
    (4, 88, 16, 3, 129, 8),      # 1 x 16 = 16 CTAs: 8 would fit, 9 time tiles
    (4, 104, 16, 3, 129, 4),     # 2 x 16 = 32 CTAs: 4 splits
    (8, 8, 4, 2, 300, 10),       # 1 x 4 = 4 CTAs: 33 would fit, 10 time tiles
])
def test_dw_splits_fill_the_card_and_no_more(k, cg, groups, b, t, want):
    """`dw_splits` as `pos_conv_dw` calls it: 1 where the tap blocks fill the
    SMs, else as many splits as fit, never more than the time tiles."""
    got = pos_conv.dw_splits(k, cg, groups, b, t, 132)
    assert got == want
    w = pos_conv.WIDTHS[cg]
    blocks = -(-k // w.dw_taps) * groups * w.dw_n_split
    tiles = b * -(-t // pos_conv.DW_TIME_TILE)
    assert 1 <= got <= max(1, tiles) and (got == 1 or blocks * got <= 132)


@pytest.mark.parametrize("cg", sorted(pos_conv.WIDTHS))
def test_tap_boxes_load_exactly_the_group(cg):
    """A tap's 64-column boxes hold the group's CG x CG weights of that tap
    and zeros past them (rows CG .. tap_rows - 1, columns CG .. of the last
    box): never the next group's columns, which a 3-D map's box from the
    group's first column would load at 16 and 48 channels, nor the next
    tap's rows.  The window's chunks past CG are zero; the dW CTAs' output
    shares tile the group's columns, each in one 64-channel dpre box but
    at 72, 88 and 104 (a share of the whole group, in two), and a dW tap's
    tap_rows M rows read each of its CG channels."""
    groups, k = 3, 2
    rows = pos_conv.tap_rows(cg)
    w = torch.arange(1, 1 + k * cg * groups * cg, dtype=torch.float64).reshape(k, cg, groups * cg)
    for tap in range(k):
        for g in range(groups):
            boxes = _tap_boxes(w, tap, g, cg)
            assert len(boxes) == -(-cg // BOX) and all(box.shape == (rows, BOX) for box in boxes)
            tile = torch.cat(boxes, dim=1)
            assert torch.equal(tile[:cg, :cg], w[tap][:, g * cg:(g + 1) * cg])
            assert not tile[cg:].any() and not tile[:, cg:].any()
    x = torch.arange(1, 1 + 2 * 5 * groups * cg, dtype=torch.float64).reshape(2, 5, groups * cg)
    win = _window(x, 1, cg, 2, 4)
    assert win.shape == (2, 8, rows) and not win[..., cg:].any()
    assert torch.equal(win[:, 2:7, :cg], x[:, :, cg:2 * cg])
    w = pos_conv.WIDTHS[cg]
    kn = cg // w.dw_n_split
    assert w.dw_n_split * kn == cg and kn % 8 == 0 and -(-kn // BOX) == (2 if cg in (72, 88, 104) else 1)
    taps = w.dw_taps
    m_rows = pos_conv.dw_tap_rows(cg, taps)
    a_rows = _dw_a_rows(cg, taps)
    assert len(a_rows) == taps * m_rows and len(a_rows) % 128 == 0
    cols = pos_conv.dw_window_cols(cg)
    for tap in range(taps):
        real = [a_rows[tap * m_rows + i] for i in range(cg)]
        assert real == [(tap, i) for i in range(cg)]
        # padding rows read inside the x window and their own tap
        assert all(t == tap and ch < max(cg, cols) for t, ch in a_rows[tap * m_rows + cg:(tap + 1) * m_rows])


def _dw_bank_groups(cg, cols):
    """For every ldmatrix_x4_trans of a dW CTA (consumer warpgroup, m64 tile,
    warp, k step of 16 time steps) and each of its four 8 x 8 matrices, the
    16-byte bank group (address / 16 mod 8) of each of the matrix's 8 rows,
    by the kernel's addresses: window rows of `cols` channels, with the
    128-byte swizzle (chunk c of row r at c ^ r % 8) where `cols` is 64,
    plain otherwise; the stage 1024-byte aligned."""
    taps = pos_conv.WIDTHS[cg].dw_taps
    rows = pos_conv.dw_tap_rows(cg, taps)
    m_rows = taps * rows
    pitch = 2 * cols
    out = []
    for wg in range(2):
        for m in range(m_rows // 128):
            for w in range(4):
                for j in range(pos_conv.DW_TIME_TILE // 16):
                    addrs = []
                    for lane in range(32):
                        mrow = wg * (m_rows // 2) + m * 64 + 16 * w + 8 * ((lane >> 3) & 1)
                        i = mrow % rows
                        r = mrow // rows + (lane & 7) + ((lane >> 4) & 1) * 8
                        c = (i if i < cg else i - 8) // 8
                        off = r * 128 + (((c ^ r) & 7) << 4) if cols == BOX else r * pitch + c * 16
                        addrs.append(off + j * 16 * pitch)
                    out.extend([[(a // 16) % 8 for a in addrs[8 * q:8 * q + 8]] for q in range(4)])
    return out


@pytest.mark.parametrize("cg", [48, 64, 80, 120, 32, 96, 112, 128, 8, 24, 40, 56, 72, 88, 104])
def test_dw_window_ldmatrix_rows_hit_distinct_banks(cg):
    """Each 8-row matrix of the dW kernel's ldmatrix_x4_trans reads 8 rows of
    16 bytes, one phase of the shared memory's 32 banks: the rows must start
    in 8 distinct 16-byte bank groups, or the load is serialised.  The
    window of `dw_window_cols` channels has that at every width; at 80 an
    unpadded row (160 bytes) puts rows r and r + 4 on the same banks, and so
    do rows of 96 and 128 channels (192, 256 bytes)."""
    cols = pos_conv.dw_window_cols(cg)
    assert cols >= min(cg, BOX) and (2 * cols) % 16 == 0
    for groups in _dw_bank_groups(cg, cols):
        assert len(set(groups)) == 8
    if cg in (80, 96, 128):
        assert any(len(set(groups)) < 8 for groups in _dw_bank_groups(cg, cg))


def test_forward_shared_memory_fits_the_block():
    """Each width's `max_taps` against the forward / dx kernel's shared
    memory as its header note lays it out (`FwdLayout::bytes`): 1024 bytes
    of alignment slack, 4 weight slots of ceil(CG / 64) boxes of tap_rows
    rows x 64 columns, 8 bytes a barrier, and a window of 256 + K rows of
    tap_rows bf16 channels; 144,448 bytes at 80 channels a group and 128
    taps, 230,464 at 120 and 128, of the 232,448 a block may take.  At 120
    and 128 the most taps that fit is 132, and `supports` stops there; at
    the other widths 128 taps fit with room to spare, and up to 64 two CTAs
    an SM.  An odd multiple of 8 takes the bytes of the multiple of 16
    above it."""
    def fwd_bytes(cg, k):
        rows = pos_conv.tap_rows(cg)
        slot = -(-cg // BOX) * rows * BOX * 2
        return 1024 + 4 * slot + 2 * 4 * 8 + (256 + k) * rows * 2

    limit = 232_448
    assert pos_conv.SMEM_PER_BLOCK == limit
    assert fwd_bytes(80, 128) == 144_448 and fwd_bytes(120, 128) == fwd_bytes(128, 128) == 230_464
    assert (fwd_bytes(32, 128), fwd_bytes(96, 128), fwd_bytes(112, 128)) == (42_048, 173_120, 201_792)
    for cg in (8, 24, 40, 56, 72, 88, 104):  # the layout of the multiple of 16 above
        assert fwd_bytes(cg, 128) == fwd_bytes(cg + 8, 128)
    for cg in (8, 16, 24, 32, 40, 48, 56, 64):
        assert 2 * fwd_bytes(cg, 128) <= limit
    for cg, w in pos_conv.WIDTHS.items():
        assert fwd_bytes(cg, 128) <= limit and pos_conv.fwd_smem_bytes(cg, 128) == fwd_bytes(cg, 128)
        most = max(k for k in range(w.tap_step, 8192, w.tap_step) if fwd_bytes(cg, k) <= limit)
        assert w.max_taps == most >= 128
    assert pos_conv.WIDTHS[120].max_taps == pos_conv.WIDTHS[128].max_taps == 132
    for c in (1920, 2048):
        for k in (128, 132, 136):
            assert pos_conv.supports(c, 16, torch.bfloat16, k) is (k <= 132)
