"""The port's row scatter-add against the JAX package on the CPU.

`scatter_rows_add_plain` (what the CUDA kernel computes: every addend enters
the f32 sum exactly) against XLA's `.at[].add` and against the Pallas kernel
in interpret mode, which rounds each addend to bf16: so f32 addends agree
with XLA to summation order and with the Pallas kernel to bf16 rounding, and
bf16 addends agree with both to summation order.  The cases are those of
`tests/test_pretraining.py::test_scatter_rows_add_matches_xla_scatter`
(duplicates, N = 1000, one row with a single destination) plus the sampler's
own skew: runs of sources on row 0.  On the CPU the wrapper runs the plain
version and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu.ops.pallas import scatter_add as jax_scatter
from gsoc_wav2vec2_tpu_torch.ops.kernels import scatter_add

torch.set_num_threads(2)

B, N, D, L = 3, 1000, 128, 64  # N not a multiple of the Pallas chunk


def _case(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    dneg = rng.standard_normal((B, N, D)).astype(np.float32)
    idx = rng.integers(0, L, size=(B, N)).astype(np.int32)
    if kind == "one_index":
        idx[1] = 7  # one row scatters everything onto index 7
    elif kind == "hot_row_0":
        # the negative sampler's shape: runs of 10 consecutive sources on row 0
        runs = np.repeat(rng.random((B, N // 10)) < 0.6, 10, axis=1)
        idx[runs] = 0
    elif kind != "uniform":
        raise ValueError(kind)
    return dneg, idx


def _xla_scatter(dneg, idx):
    out = jnp.zeros((B, L, D), jnp.float32)
    return np.asarray(out.at[jnp.arange(B)[:, None], jnp.asarray(idx)].add(
        jnp.asarray(dneg, jnp.float32)))


CASES = ["uniform", "one_index", "hot_row_0"]


@pytest.mark.parametrize("kind", CASES)
def test_plain_f32_matches_xla_scatter(kind):
    dneg, idx = _case(kind)
    got = scatter_add.scatter_rows_add_plain(
        torch.from_numpy(dneg), torch.from_numpy(idx), l_rows=L)
    assert got.shape == (B, L, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _xla_scatter(dneg, idx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", CASES)
def test_plain_f32_matches_pallas_kernel_to_bf16_rounding(kind):
    """The Pallas kernel rounds each addend to bf16; the port adds f32."""
    dneg, idx = _case(kind, seed=1)
    assert jax_scatter.supports(L, D)
    want = np.asarray(jax_scatter.scatter_rows_add(
        jnp.asarray(dneg), jnp.asarray(idx), l_rows=L, interpret=True))
    got = scatter_add.scatter_rows_add_plain(
        torch.from_numpy(dneg), torch.from_numpy(idx), l_rows=L).numpy()
    # 6e-2 covers rows of up to ~64 unit-scale addends (the JAX package's own
    # on-chip tolerance).  A row of n addends collects n rounding residues of
    # up to 2^-9 relative each, a random walk of sigma ~ 2^-9 / sqrt(3) *
    # sqrt(n): for the 600-1000 addends of the skewed cases allow
    # 2^-7 * sqrt(n), about 7 sigma
    most = max(np.bincount(row, minlength=L).max() for row in idx)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=max(6e-2, 2.0**-7 * np.sqrt(most)))


@pytest.mark.parametrize("kind", CASES)
def test_plain_bf16_matches_pallas_kernel_and_xla(kind):
    """bf16 cotangents: the rounding has already happened, all three agree
    to summation order."""
    dneg, idx = _case(kind, seed=2)
    dneg_bf16 = torch.from_numpy(dneg).to(torch.bfloat16)
    rounded = dneg_bf16.float().numpy()
    got = scatter_add.scatter_rows_add_plain(dneg_bf16, torch.from_numpy(idx), l_rows=L)
    assert got.dtype == torch.float32
    want = np.asarray(jax_scatter.scatter_rows_add(
        jnp.asarray(rounded).astype(jnp.bfloat16), jnp.asarray(idx), l_rows=L, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _xla_scatter(rounded, idx), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_runs_the_plain_version(dtype):
    dneg, idx = _case("hot_row_0", seed=3)
    x, i = torch.from_numpy(dneg).to(dtype), torch.from_numpy(idx)
    scatter_add.scatter_rows_add.launches = 0
    got = scatter_add.scatter_rows_add(x, i, l_rows=L)
    assert torch.equal(got, scatter_add.scatter_rows_add_plain(x, i, l_rows=L))
    assert scatter_add.scatter_rows_add.launches == 0  # a launch is counted on the card only


def test_wrapper_refuses_mismatched_shapes_and_plain_refuses_bad_indices():
    dneg, idx = _case("uniform")
    x, i = torch.from_numpy(dneg), torch.from_numpy(idx)
    with pytest.raises(ValueError, match="dneg"):
        scatter_add.scatter_rows_add(x, i[:, :-1], l_rows=L)
    with pytest.raises(ValueError, match="dneg"):
        scatter_add.scatter_rows_add(x[0], i[0], l_rows=L)
    bad = i.clone()
    bad[0, 0] = L
    with pytest.raises((IndexError, RuntimeError)):
        scatter_add.scatter_rows_add_plain(x, bad, l_rows=L)


@pytest.mark.parametrize("l_rows,d", [(768, 256), (768, 768), (1536, 256), (24, 40), (1000, 100)])
def test_supports_the_recipe_shapes_and_more(l_rows, d):
    """Every shape the Pallas kernel takes, and the widths and row counts it
    refuses (no multiple of 128 / 8)."""
    assert scatter_add.supports(l_rows, d)
    if jax_scatter.supports(l_rows, d):
        assert d % 128 == 0 and l_rows % 8 == 0
    assert not scatter_add.supports(0, d) and not scatter_add.supports(l_rows, 0)
