"""The scatter kernel's sort and share cut, in plain torch, on the CPU.

`scatter_add.scatter_plan` follows the plan kernel step by step (32 warps,
each a contiguous part of the sources, histograms scanned warp by warp
within a key, ranks among equal keys of lower lanes); it must be a stable
counting sort: per batch row `order` is `torch.argsort(idx, stable=True)`
over the listed sources and `start` the prefix of their bincount.
`scatter_add.scatter_rows_add_by_shares` follows the sum kernel's partition
(contiguous shares of the listed sources that differ by at most one, a
row cut by a share boundary added piece by piece in share order) and must give the scatter-add.
"""

import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu_torch.models import pretraining
from gsoc_wav2vec2_tpu_torch.ops.kernels import scatter_add

torch.set_num_threads(2)

B, L, K = 3, 48, 20  # frames, negatives per frame: N = 960 sources a batch row


def _indices(kind: str) -> torch.Tensor:
    """(B, L K) int32 row-local indices of each kind."""
    rng = np.random.default_rng(len(kind))
    if kind == "sampler":
        # the port's negative sampler over a ragged span mask: unmasked
        # frames send their K copies to row 0
        lengths = np.array([L, 31, 17])
        mask = (rng.random((B, L)) < 0.5) & (np.arange(L)[None, :] < lengths[:, None])
        negs = pretraining.sample_negative_indices(
            torch.Generator().manual_seed(3), torch.from_numpy(mask), K)
        return negs - (torch.arange(B) * L)[:, None, None].to(torch.int32)
    if kind == "uniform":
        return torch.from_numpy(rng.integers(0, L, (B, L * K)).astype(np.int32))
    if kind == "one_row":
        return torch.full((B, L * K), 7, dtype=torch.int32)
    # out of range on both sides: dropped by the kernel
    idx = rng.integers(-5, L + 5, (B, L * K)).astype(np.int32)
    return torch.from_numpy(idx)


KINDS = ["sampler", "uniform", "one_row", "out_of_range"]


@pytest.mark.parametrize("kind", KINDS)
def test_plan_is_a_stable_counting_sort(kind):
    idx = _indices(kind).reshape(B, -1)
    order, start = scatter_add.scatter_plan(idx, L)
    assert order.shape == idx.shape and start.shape == (B, L + 1)
    for i in range(B):
        listed = (idx[i] >= 0) & (idx[i] < L)
        keys = idx[i].long()[listed]
        want = torch.arange(idx.shape[1])[listed][torch.argsort(keys, stable=True)]
        count = int(start[i, L])
        assert count == int(listed.sum())
        assert torch.equal(order[i, :count], want)
        assert (order[i, count:] == -1).all()
        assert start[i, 0] == 0
        assert torch.equal(start[i, 1:], torch.cumsum(torch.bincount(keys, minlength=L), 0))
    if kind == "sampler":
        assert (idx == 0).float().mean().item() >= 0.3  # the hot row


@pytest.mark.parametrize("total,shares", [(0, 4), (5, 8), (2880, 264), (2881, 7), (97, 97)])
def test_shares_differ_by_at_most_one_source(total, shares):
    bounds = scatter_add.share_bounds(total, shares)
    sizes = [g1 - g0 for g0, g1 in bounds]
    assert len(bounds) == shares and bounds[0][0] == 0 and bounds[-1][1] == total
    assert all(bounds[p][1] == bounds[p + 1][0] for p in range(shares - 1))
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("shares", [1, 7, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_split_runs_summed_in_share_order_give_the_scatter(kind, shares):
    """Pieces of rows cut by share boundaries, added in share order, match
    the plain scatter-add at 2e-5 of the output scale; rows with no source
    are zero."""
    idx = _indices(kind).reshape(B, -1)
    rng = np.random.default_rng(shares)
    dneg = torch.from_numpy(rng.standard_normal((B, idx.shape[1], 16)).astype(np.float32))
    listed = (idx >= 0) & (idx < L)
    want = scatter_add.scatter_rows_add_plain(
        dneg * listed[..., None], torch.where(listed, idx, torch.zeros_like(idx)), l_rows=L)
    got = scatter_add.scatter_rows_add_by_shares(dneg, idx, l_rows=L, shares=shares)
    assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()
    has_source = torch.stack([torch.bincount(idx[i][listed[i]].long(), minlength=L) > 0
                              for i in range(B)])
    assert not got[~has_source].any()
    if kind in ("sampler", "one_row"):
        assert (~has_source).any()


@pytest.mark.parametrize("kind", KINDS)
def test_split_runs_are_exact_on_integer_data(kind):
    """On integer-valued f32 addends every partial sum is exact, so the
    share partition gives the scatter-add bit for bit."""
    idx = _indices(kind).reshape(B, -1)
    rng = np.random.default_rng(11)
    dneg = torch.from_numpy(rng.integers(-8, 9, (B, idx.shape[1], 8)).astype(np.float32))
    listed = (idx >= 0) & (idx < L)
    want = scatter_add.scatter_rows_add_plain(
        dneg * listed[..., None], torch.where(listed, idx, torch.zeros_like(idx)), l_rows=L)
    got = scatter_add.scatter_rows_add_by_shares(dneg, idx, l_rows=L, shares=13)
    assert torch.equal(got, want)
