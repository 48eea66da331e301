"""The port's CTC (`ops/kernels/ctc.py`, `ops/ctc.py::ctc_loss_fn`) against the
JAX package's `ctc_loss_fn` (`optax.ctc_loss`): loss and the logits'
gradient, on feasible rows, repeated labels, a row whose labels cannot fit
its frames (finite in both, where `F.ctc_loss` gives inf), short logit
lengths, a label tensor of width 0 and one long row.  Also the kernels' own split in torch
(`ctc_loss_fwd_plain` + `ctc_adjoint_plain`, the adjoint over the saved
states) against autograd through the plain loop.

Tolerances: loss rtol 1e-5; the gradient atol 1e-5 against `jax.grad` on
the infeasible row's case.  The two run the same f32 recursion, but XLA's
exp, log1p and log_softmax round differently from torch's in the last bit,
and the log-domain states carry an absolute error of about eps32 x
|log-likelihood|, which the gradient inherits: at 50 frames the two differ
by up to 1.5e-5 (held at 2e-5), at the long row (loss ~1.2e4) by up to 4e-4
while both are ~0.06 from a float64 reference (held at 2 eps32 x loss).  So
every case is also held to a float64 run of the same recursion: the port's
gradient no further from it than JAX's, within 10% + 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu.ops.ctc import ctc_loss_fn as jax_ctc_loss_fn
from gsoc_wav2vec2_tpu_torch.ops import ctc
from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc as ctc_kernel

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _labels(rng, b, n, v, lo, hi, alphabet=None):
    labels = np.zeros((b, n), np.int64)
    for i in range(b):
        m = int(rng.integers(lo, hi + 1))
        labels[i, :m] = rng.integers(1, alphabet or v, size=m)
    return labels


def _case(name):
    """(logits (B, T, V) f32, labels (B, N), logit lengths (B,))."""
    if name == "infeasible":
        # row 1: 8 labels, 6 of them needing a separating blank, in 10 frames
        logits = np.random.default_rng(0).standard_normal((2, 10, 8)).astype(np.float32)
        labels = np.array([[1, 2, 3, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1, 2, 2]])
        return logits, labels, np.array([10, 10])
    rng = np.random.default_rng({"feasible": 1, "repeats": 2, "short": 3, "long": 4,
                                 "no labels": 5}[name])
    if name == "long":
        logits = rng.standard_normal((1, 5999, 8)).astype(np.float32)
        return logits, _labels(rng, 1, 200, 8, 50, 200), np.array([5999])
    logits = rng.standard_normal((4, 50, 32)).astype(np.float32)
    if name == "feasible":
        return logits, _labels(rng, 4, 16, 32, 3, 12), np.full(4, 50)
    if name == "no labels":  # a label tensor of width 0: the loss is the blank path's
        return logits, np.zeros((4, 0), np.int64), np.array([50, 33, 21, 9])
    if name == "repeats":  # a two-letter alphabet: runs of equal labels
        return logits, _labels(rng, 4, 16, 32, 6, 16, alphabet=3), np.full(4, 50)
    return logits, _labels(rng, 4, 16, 32, 3, 9), np.array([50, 33, 21, 9])


def _jax(logits, labels, lengths):
    args = (jnp.asarray(labels), jnp.asarray(lengths))
    loss = np.asarray(jax_ctc_loss_fn(jnp.asarray(logits), *args, 0))
    grad = np.asarray(jax.grad(lambda x: jnp.sum(jax_ctc_loss_fn(x, *args, 0)))(jnp.asarray(logits)))
    return loss, grad


def _port(fn, logits, labels, lengths):
    x = torch.tensor(logits, requires_grad=True)
    loss = fn(x, torch.tensor(labels), torch.tensor(lengths))
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _float64_grad(logits, labels, lengths):
    """The logits' gradient of the recursion run in float64."""
    x = torch.tensor(logits.astype(np.float64), requires_grad=True)
    lp = torch.log_softmax(x, -1)
    lab, n = torch.tensor(labels), torch.tensor(lengths)
    _, states = ctc_kernel.ctc_loss_fwd_plain(lp.detach(), lab, n)
    ones = torch.ones(len(lengths), dtype=torch.float64)
    lp.backward(ctc_kernel.ctc_adjoint_plain(lp.detach(), lab, n, states, ones))
    return x.grad.numpy()


def _as_close_to_float64(grad, want_grad, logits, labels, lengths):
    exact = _float64_grad(logits, labels, lengths)
    assert np.abs(grad - exact).max() <= 1.1 * np.abs(want_grad - exact).max() + 1e-5


def _plain(x, labels, lengths):
    return ctc_kernel.ctc_loss_plain(torch.log_softmax(x, -1), labels, lengths, 0)


def _split(x, labels, lengths):
    """The kernels' split in torch: forward with saved states, explicit adjoint."""
    return _Split.apply(x, labels, lengths)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, labels, lengths):
        lp = torch.log_softmax(x, -1)
        loss, states = ctc_kernel.ctc_loss_fwd_plain(lp, labels, lengths, 0)
        ctx.save_for_backward(lp, labels, lengths, states)
        return loss

    @staticmethod
    def backward(ctx, g):
        lp, labels, lengths, states = ctx.saved_tensors
        glp = ctc_kernel.ctc_adjoint_plain(lp, labels, lengths, states, g, 0)
        # log_softmax's backward: glp - softmax * sum(glp)
        return glp - lp.exp() * glp.sum(-1, keepdim=True), None, None


FNS = {"ctc_loss_fn": lambda x, l, n: ctc.ctc_loss_fn(x, l, n, 0),
       "ctc_loss_plain": _plain, "kernel_split": _split}


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("name", ["feasible", "repeats", "infeasible", "short", "no labels"])
def test_ctc_matches_jax(name, fn):
    logits, labels, lengths = _case(name)
    want_loss, want_grad = _jax(logits, labels, lengths)
    loss, grad = _port(FNS[fn], logits, labels, lengths)
    assert np.all(np.isfinite(loss)) and np.all(np.isfinite(grad))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-5 if name == "infeasible" else 2e-5)
    _as_close_to_float64(grad, want_grad, logits, labels, lengths)
    if name == "infeasible":
        # JAX's large finite loss (log 0 = -1e5), where F.ctc_loss gives inf
        np.testing.assert_allclose(loss[1], 100014.20, rtol=1e-5)
    if name == "short":
        for i, n in enumerate(lengths):
            assert not grad[i, n:].any(), f"row {i}: gradient past its {n} frames"


def test_ctc_long_row_matches_jax():
    """One row of 5999 frames at V = 8, labels 50-200: loss rtol 1e-5; the
    gradient within the f32 resolution of the log-likelihood of JAX's, and
    as close to the float64 gradient as JAX's is."""
    logits, labels, lengths = _case("long")
    want_loss, want_grad = _jax(logits, labels, lengths)
    loss, grad = _port(FNS["ctc_loss_fn"], logits, labels, lengths)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=2 * EPS32 * float(want_loss.max()))
    _as_close_to_float64(grad, want_grad, logits, labels, lengths)


@pytest.mark.parametrize("name", ["feasible", "repeats", "infeasible", "short", "no labels"])
def test_kernel_split_matches_autograd(name):
    """The adjoint over the saved states (what the backward kernels compute)
    against autograd through the plain loop: the same function, summed in
    another order; the forward's loss is the loop's, bit for bit."""
    logits, labels, lengths = _case(name)
    lp = torch.log_softmax(torch.tensor(logits), -1)
    lab, n = torch.tensor(labels), torch.tensor(lengths)
    x = lp.clone().requires_grad_(True)
    want = ctc_kernel.ctc_loss_plain(x, lab, n)
    g = torch.linspace(0.5, 2.0, len(lengths))
    (want * g).sum().backward()
    loss, states = ctc_kernel.ctc_loss_fwd_plain(lp, lab, n)
    assert torch.equal(loss, want.detach())
    grad = ctc_kernel.ctc_adjoint_plain(lp, lab, n, states, g)
    torch.testing.assert_close(grad, x.grad, rtol=0, atol=2e-6)


def test_two_backwards_are_bit_equal():
    logits, labels, lengths = _case("repeats")
    grads = [_port(FNS["ctc_loss_fn"], logits, labels, lengths)[1] for _ in range(2)]
    assert np.array_equal(grads[0], grads[1])


def test_ctc_supports():
    assert ctc_kernel.supports(2 * 1024, 32, 0) and ctc_kernel.supports(1, 1, 0)
    assert not ctc_kernel.supports(ctc_kernel.MAX_LABELS + 1, 32, 0)
    assert not ctc_kernel.supports(16, 32, 32)
    assert ctc_kernel.supports(16, 50000, 0) and ctc_kernel.supports(0, 32, 0)


def _owners(lane_slots, warps):
    """(warp, lane, slot, position) of every chain slot of the kernels'
    layout (`csrc/ctc.cu`): lane l of warp w owns positions
    slot * 32 W + 32 w + l."""
    for w in range(warps):
        for lane in range(32):
            for i in range(lane_slots):
                yield w, lane, i, i * 32 * warps + 32 * w + lane


def _source_is(owner_of, lane_slots, warps, step):
    """Every chain slot's neighbour (n - 1 for the forward's emit value,
    n + 1 for the backward's adjoint) is where the kernels take it from:
    lane l -/+ 1 of the same warp and slot, else lane 31 / 0 of the warp
    before / after, else that of the last / first warp in the slot before /
    after (`csrc/ctc.cu`)."""
    for w, lane, i, n in _owners(lane_slots, warps):
        if step < 0:
            src = ((w, lane - 1, i) if lane else (w - 1, 31, i) if w else
                   (warps - 1, 31, i - 1) if i else None)
        else:
            src = ((w, lane + 1, i) if lane < 31 else (w + 1, 0, i) if w + 1 < warps else
                   (0, 0, i + 1) if i + 1 < lane_slots else None)
        if src is None:
            assert n == (0 if step < 0 else 32 * lane_slots * warps - 1)
        else:
            assert owner_of[src] == n + step


@pytest.mark.parametrize("vocab", [32, 8192, 50])
def test_ctc_plan_covers_every_label_width(vocab):
    """The host's plan for every label width N = 0..MAX_LABELS: each of the
    positions 0..N owned by exactly one chain slot in the forward's and the
    backward's layouts (the slots a bijection onto 0..32 P W - 1, each
    neighbour where the kernels read it); an instance that is compiled; the
    blocks within the kernels' thread and shared-memory limits; the rings
    and staging large enough for a chunk (a bulk chunk of V classes, or the
    L gathered classes and the blank; 2L + 1 staged words a frame; a frame
    of coefficients for each coefficient group twice)."""
    k = ctc_kernel
    checked = set()
    for n in range(k.MAX_LABELS + 1):
        p = k.plan(n, vocab)
        assert p.fwd_lane_slots in (1, 2, 4, 8) and p.fwd_lane_slots == k.fwd_lane_slots(n)
        for slots_a_lane, warps in ((p.fwd_lane_slots, p.fwd_warps),
                                    (k.BWD_LANE_SLOTS, p.bwd_warps)):
            slots = 32 * slots_a_lane * warps
            assert slots >= n + 1 and slots - 32 * slots_a_lane < n + 1  # as few warps as N needs
            assert 2 * n + 1 <= 2 * slots                                  # the staged words
            if (slots_a_lane, warps) not in checked:
                checked.add((slots_a_lane, warps))
                owner_of = {(w, lane, i): q for w, lane, i, q in _owners(slots_a_lane, warps)}
                assert sorted(owner_of.values()) == list(range(slots))
                _source_is(owner_of, slots_a_lane, warps, -1)
                _source_is(owner_of, slots_a_lane, warps, +1)
        fwd_slots = 32 * p.fwd_lane_slots * p.fwd_warps
        assert p.fwd_warps <= k.MAX_CHAIN_WARPS
        assert p.fwd_threads <= k.MAX_THREADS and p.bwd_threads <= k.MAX_THREADS
        assert p.bulk == (vocab % 4 == 0 and vocab <= fwd_slots + 1)
        assert p.stride >= (vocab if p.bulk else fwd_slots + 1)
        assert 1 <= p.frames <= k.MAX_CHUNK and 1 <= p.bwd_frames <= k.MAX_CHUNK
        assert p.stages >= 2 and p.out_stages >= 2
        assert p.coef_warps % p.coef_groups == 0 and p.coef_frames == 2 * p.coef_groups
        assert p.fwd_smem == k.fwd_smem_bytes(p.fwd_lane_slots, p.fwd_warps, n, p.frames, p.stages,
                                              p.out_stages, p.stride)
        assert p.bwd_smem == k.bwd_smem_bytes(p.bwd_warps, n, p.coef_frames, p.bwd_frames,
                                              p.out_stages)
        ring = 4 * p.stages * p.frames * p.stride
        stage = 4 * p.out_stages * p.frames * 2 * fwd_slots
        assert ring + stage + 4 * n <= p.fwd_smem <= k.SMEM_LIMIT
        bwd_slots = 32 * k.BWD_LANE_SLOTS * p.bwd_warps
        coef = 4 * p.coef_frames * 6 * bwd_slots
        assert coef + k.SORT_BYTES + 4 * n <= p.bwd_smem <= k.SMEM_LIMIT
    assert not k.supports(k.MAX_LABELS + 1, vocab, 0)


def test_ctc_plan_of_the_recipe():
    """The recipe's 200 labels at V = 32: one slot a lane in 7 forward chain
    warps, the log-probs copied whole; one backward chain warp (the W = 1
    instance) with 12 coefficient warps, each a group of its own; an
    unaligned tensor gathers."""
    p = ctc_kernel.plan(200, 32)
    assert (p.fwd_lane_slots, p.fwd_warps, p.bulk, p.stride) == (1, 7, True, 32)
    assert (p.bwd_warps, p.coef_warps, p.coef_groups, p.bwd_threads) == (1, 12, 12, 512)
    q = ctc_kernel.plan(200, 32, aligned=False)
    assert (q.bulk, q.stride) == (False, 225)
