"""The flash wrappers' TMA layout rules, on the CPU: the tensor-map dims,
byte strides and box that `csrc/flash_attention.cu::encode_bhld` builds from
a (B, H, L, 64) view's strides (mirrored by `tma_layout`), and the views the
wrappers refuse to hand to TMA (copied instead)."""

import pytest
import torch

from gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention import _check, _dense, _strided_ok, tma_layout

torch.set_num_threads(2)


def _proj_view(b, l, h):
    """The head split of a (B, L, H*64) projection, as `split_heads` gives it."""
    return torch.zeros(b, l, h * 64, dtype=torch.bfloat16).view(b, l, h, 64).transpose(1, 2)


@pytest.mark.parametrize("b,h,l", [(16, 12, 768), (8, 16, 768), (1, 12, 5999), (3, 2, 1)])
def test_contiguous_heads_map_rows_then_heads(b, h, l):
    x = torch.zeros(b, h, l, 64, dtype=torch.bfloat16)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride())
    assert not heads_inner
    assert dims == [64, l, h, b]
    if l > 1:
        assert strides == [128, l * 128, h * l * 128]
    assert box == [64, 64, 1, 1]
    assert _strided_ok(x)


@pytest.mark.parametrize("b,h,l", [(16, 12, 768), (32, 12, 768), (8, 16, 768), (1, 12, 5999), (2, 3, 65)])
def test_projection_views_map_heads_then_rows(b, h, l):
    """The heads of a frame lie side by side: (64, H, L, B), strides ascending,
    so the kernels read the projections in place."""
    x = _proj_view(b, l, h)
    dims, strides, box, heads_inner = tma_layout(x.shape, x.stride())
    assert heads_inner
    assert dims == [64, h, l, b]
    assert strides == [128, h * 128, l * h * 128]
    assert box == [64, 1, 64, 1]
    assert _strided_ok(x)


def test_size_one_dims_get_the_packed_stride():
    """One head of a projection (sh == sl == 64): rows first, and the head
    dimension of size 1 gets the stride of the rows below it."""
    x = _proj_view(2, 100, 1)
    dims, strides, _, heads_inner = tma_layout(x.shape, x.stride())
    assert not heads_inner and dims == [64, 100, 1, 2]
    assert strides == [128, 100 * 128, 100 * 128]
    assert _strided_ok(x)
    # a size-1 batch whose stride is arbitrary
    y = torch.zeros(3, 4, 10, 64, dtype=torch.bfloat16)[1:2]
    assert _strided_ok(y)
    assert tma_layout(y.shape, y.stride())[1] == [128, 10 * 128, 4 * 10 * 128]


@pytest.mark.parametrize("case", ["misaligned", "odd_row_stride", "overlapping", "row_major_d"])
def test_views_that_break_tma_rules_are_refused_and_copied(case):
    base = torch.arange(2 * 3 * 40 * 64, dtype=torch.float32).to(torch.bfloat16)
    if case == "misaligned":  # base 2 bytes past a 16-byte boundary
        x = torch.empty(base.numel() + 8, dtype=torch.bfloat16)[1:1 + base.numel()].view(2, 3, 40, 64)
        x.copy_(base.view(2, 3, 40, 64))
        assert x.data_ptr() % 16
    elif case == "odd_row_stride":  # rows 68 elements apart: 136 bytes
        x = torch.zeros(2, 3, 40, 68, dtype=torch.bfloat16)[..., :64]
    elif case == "overlapping":  # every head reads the same rows
        x = torch.zeros(2, 1, 40, 64, dtype=torch.bfloat16).expand(2, 3, 40, 64)
    else:  # d not innermost
        x = torch.zeros(2, 3, 64, 40, dtype=torch.bfloat16).transpose(2, 3)
    assert not _strided_ok(x)
    y = _dense(x)
    assert _strided_ok(y) and y.is_contiguous() and torch.equal(y, x)


def test_check_hands_the_kernels_tma_ready_views():
    """`_check` keeps projection views as they are and copies q, k, v to one
    contiguous layout when one of them breaks a rule or their strides differ."""
    q, k, v = (_proj_view(2, 50, 4) for _ in range(3))
    qq, kk, vv, bias = _check("t", q, k, v, torch.zeros(2, 50))
    assert qq is q and kk is k and vv is v and bias.dtype == torch.float32
    k2 = torch.zeros(2, 4, 50, 64, dtype=torch.bfloat16)
    qq, kk, vv, _ = _check("t", q, k2, v, None)
    assert qq.stride() == kk.stride() == vv.stride() and all(map(_strided_ok, (qq, kk, vv)))
    with pytest.raises(ValueError):
        _check("t", q, k, v, torch.zeros(3, 50))
