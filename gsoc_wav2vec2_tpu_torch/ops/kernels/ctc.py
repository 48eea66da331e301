"""CTC loss and its gradient (`csrc/ctc.cu`): optax's function, deterministic.

The JAX package computes CTC with `optax.ctc_loss` (`ops/ctc.py`), a
`lax.scan` whose autodiff is deterministic.  This module computes the same
function, recursion for recursion (optax `_classification.py`,
`ctc_loss_with_forward_probs`):

* per label position n a blank state phi[n] (n = 0..N) and an emit state
  emit[n] (n = 0..N-1), started at phi[0] = 0 and everything else at
  `LOG_EPSILON` = -1e5, optax's stand-in for log 0;
* per frame t: phi'[n] = lae(phi[n], emit[n-1] + eps * repeat[n-1]) (the
  emit-to-blank step), emit[n] <- lae(phi'[n] + lp[label[n]], emit[n] +
  lp[label[n]]), phi[n] <- lae(phi'[n] + lp[blank], emit[n-1] + lp[blank] +
  eps * (1 - repeat[n-1])), with lae = log-add-exp and repeat[n] = label[n]
  == label[n+1]; a frame at or past the row's logit length leaves the state
  as it was;
* the loss: -lae(phi[L], emit[L-1]) of the last state (-phi[0] when L = 0),
  L = the number of non-pad labels.

Because log 0 is -1e5 and not -inf, a row whose labels cannot fit its frames
has a large finite loss (about 1e5 per missing frame) and a finite gradient,
as in the JAX package; `F.ctc_loss` gives inf there.  States past L never
reach the loss, so the kernel runs states 0..L only.

`ctc_loss_plain` is the recursion as a loop over frames in torch, with
autograd (the log-add-exp's derivative is JAX's, `exp(x - lae(x, y))`): the
CPU path and the yardstick.  `ctc_loss_fwd_plain` / `ctc_adjoint_plain` are
the kernels' own split, in torch: the forward saves each frame's state
(B, T, 2N+1) (phi[n] at 2n, emit[n] at 2n+1), and the backward is the
adjoint of that recursion, frame by frame from the last, over the saved
states, so that feasible and infeasible rows get optax's autodiff alike.
The cotangent of lp[t, v] is the sum over the states whose label is v
(blank: every phi state), taken in state order.

The kernels (`csrc/ctc.cu`, whose header says what bounds them):
`ctc_fwd_kernel<P>`, one block a row, the row's positions in W chain warps
of P slots a lane (no block-wide barrier a frame; the neighbour's value by
shuffle, between warps through shared memory and a barrier of the row's
warps), a producer warp that keeps the log-probs chunks of frames ahead in
an mbarrier ring, a storer warp that takes the states out;
`ctc_bwd_kernel<W>`, coefficient warps that compute each (frame,
position)'s exponentials from the saved states ahead of the chain warps
running the adjoint's linear recursion, a storer warp for the per-state
cotangents and the blank's sums, and the row's positions sorted by class;
then `ctc_grad_kernel`, one thread a (row, frame, class), which adds its
cotangents in state order.  `plan` is the host's choice of instance, warps,
ring depths and shared memory for a label width and a vocabulary.  No float
atomics: two launches on the same inputs are bit-equal.  The kernels take
up to `MAX_LABELS` label positions a row; on the card a wider label tensor
raises (`supports`), it never falls back to the plain loop.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from . import _build

LOG_EPSILON = -1e5   # optax's log 0
MAX_LABELS = 2048    # label positions a row the kernels take (states 2 x 2048 + 1)


class _LogAddExp(torch.autograd.Function):
    """`jnp.logaddexp` with JAX's derivative: d/dx = exp(x - out)."""

    @staticmethod
    def forward(ctx, x, y):
        out = _lae(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        return g * torch.exp(x - out), g * torch.exp(y - out)


def _lae(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """max(x, y) + log1p(exp(-|x - y|)), x + y where x - y is NaN."""
    delta = x - y
    return torch.where(torch.isnan(delta), x + y,
                       torch.maximum(x, y) + torch.log1p(torch.exp(-delta.abs())))


def _row_terms(log_probs, labels, pad_id):
    """(lp of each label (B, T, N), lp of blank (B, T), eps * repeat,
    eps * (1 - repeat) (B, N), label counts (B,))."""
    b, t, _ = log_probs.shape
    n = labels.shape[1]
    labels = labels.long()
    repeat = torch.zeros((b, n), dtype=torch.bool, device=labels.device)
    repeat[:, :-1] = labels[:, :-1] == labels[:, 1:]
    zero = log_probs.new_zeros(())
    eps = log_probs.new_full((), LOG_EPSILON)
    lp_emit = log_probs.gather(2, labels[:, None, :].expand(b, t, n))
    return (lp_emit, log_probs[:, :, pad_id], torch.where(repeat, eps, zero),
            torch.where(repeat, zero, eps), (labels != pad_id).sum(dim=1))


def _init_state(b: int, n: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    phi = like.new_full((b, n + 1), LOG_EPSILON)
    phi[:, 0] = 0.0
    return phi, like.new_full((b, n), LOG_EPSILON)


def _frame(phi, emit, le, lphi, er, enr, lae):
    """One frame of the recursion: (phi', next phi, next emit)."""
    phi_p = torch.cat([phi[:, :1], lae(phi[:, 1:], emit + er)], dim=1)
    next_emit = lae(phi_p[:, :-1] + le, emit + le)
    np_ = phi_p + lphi
    next_phi = torch.cat([np_[:, :1], lae(np_[:, 1:], (emit + lphi) + enr)], dim=1)
    return phi_p, next_phi, next_emit


def _frames(logit_lengths, t: int) -> int:
    """Frames to run: the state is frozen past every row's length."""
    return min(t, int(logit_lengths.max())) if logit_lengths.numel() else 0


def _read_loss(phi, emit, lab_len, lae):
    last = torch.cat([phi[:, :1], lae(phi[:, 1:], emit)], dim=1)
    return -last.gather(1, lab_len[:, None])[:, 0]


def _check(log_probs, labels, logit_lengths, pad_id):
    if log_probs.dim() != 3 or labels.dim() != 2 or labels.shape[0] != log_probs.shape[0]:
        raise ValueError(f"ctc_loss takes log_probs (B, T, V) and labels (B, N), got "
                         f"{tuple(log_probs.shape)} and {tuple(labels.shape)}")
    if logit_lengths.shape != (log_probs.shape[0],):
        raise ValueError(f"logit_lengths must be (B,), got {tuple(logit_lengths.shape)}")
    if not 0 <= pad_id < log_probs.shape[2]:
        raise ValueError(f"pad_id {pad_id} outside the {log_probs.shape[2]} classes")


def _recursion(log_probs, labels, logit_lengths, pad_id, lae, states=None):
    """The loss (B,) of the recursion over frames; with `states` (B, T, 2N+1)
    each frame's state is stored there."""
    b, t, _ = log_probs.shape
    lengths = torch.as_tensor(logit_lengths, device=log_probs.device).long()
    lp_emit, lp_phi, er, enr, lab_len = _row_terms(log_probs, labels, pad_id)
    phi, emit = _init_state(b, labels.shape[1], log_probs)
    for s in range(_frames(lengths, t)):
        _, next_phi, next_emit = _frame(phi, emit, lp_emit[:, s], lp_phi[:, s:s + 1], er, enr, lae)
        live = (s < lengths)[:, None]
        phi = torch.where(live, next_phi, phi)
        emit = torch.where(live, next_emit, emit)
        if states is not None:
            states[:, s, 0::2], states[:, s, 1::2] = phi, emit
    return _read_loss(phi, emit, lab_len, lae)


def ctc_loss_plain(log_probs: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor,
                   pad_id: int = 0) -> torch.Tensor:
    """(B, T, V) f32 log-probs, (B, N) pad-padded labels, (B,) logit lengths
    -> (B,) per-row loss, differentiable in `log_probs` through autograd."""
    _check(log_probs, labels, logit_lengths, pad_id)
    return _recursion(log_probs.float(), labels, logit_lengths, pad_id, _LogAddExp.apply)


def ctc_loss_fwd_plain(log_probs, labels, logit_lengths, pad_id: int = 0):
    """The forward kernel's function in torch: (loss (B,), states (B, T, 2N+1)),
    state t the one after frame t (frozen past a row's length; frames past
    every row's length are not written).  It and `ctc_adjoint_plain` compute
    in `log_probs`' dtype (float64 gives the tests an exact reference)."""
    _check(log_probs, labels, logit_lengths, pad_id)
    b, t, _ = log_probs.shape
    states = log_probs.new_empty((b, t, 2 * labels.shape[1] + 1))
    return _recursion(log_probs, labels, logit_lengths, pad_id, _lae, states), states


def ctc_adjoint_plain(log_probs, labels, logit_lengths, states, grad_loss, pad_id: int = 0):
    """The backward kernels' function in torch: d(sum grad_loss * loss) /
    d log_probs (B, T, V), the adjoint of the recursion over the saved
    `states`, frame by frame from the last."""
    b, t, v = log_probs.shape
    n = labels.shape[1]
    dev = log_probs.device
    lengths = logit_lengths.long()
    lp_emit, lp_phi, er, enr, lab_len = _row_terms(log_probs, labels, pad_id)
    phi0, emit0 = _init_state(b, n, log_probs)
    rows = torch.arange(b, device=dev)
    last = (lengths.clamp(0, t) - 1).clamp_min(0)
    started = (lengths > 0)[:, None]
    phi_f = torch.where(started, states[rows, last, 0::2], phi0)
    emit_f = torch.where(started, states[rows, last, 1::2], emit0)
    # the read-out: loss = -lae(phi[L], emit[L-1]), or -phi[0] at L = 0
    g = -grad_loss.to(log_probs.dtype)
    dphi = log_probs.new_zeros((b, n + 1))
    demit = log_probs.new_zeros((b, n))
    if n:
        has = lab_len > 0
        lm1 = (lab_len - 1).clamp_min(0)
        x, y = phi_f[rows, lab_len], emit_f[rows, lm1]
        out = _lae(x, y)
        dphi[rows, lab_len] = torch.where(has, g * torch.exp(x - out), g)
        demit[rows, lm1] = torch.where(has, g * torch.exp(y - out), torch.zeros_like(g))
    else:
        dphi[:, 0] = g
    grad = log_probs.new_zeros((b, t, v))
    labels = labels.long()
    for s in reversed(range(_frames(lengths, t))):
        phi, emit = (states[:, s - 1, 0::2], states[:, s - 1, 1::2]) if s else (phi0, emit0)
        le, lphi = lp_emit[:, s], lp_phi[:, s:s + 1]
        a = emit + er
        phi_p, _, _ = _frame(phi, emit, le, lphi, er, enr, _lae)
        xs, ys = phi_p[:, :-1] + le, emit + le
        e = _lae(xs, ys)
        dx, dy = demit * torch.exp(xs - e), demit * torch.exp(ys - e)
        p, c = phi_p + lphi, (emit + lphi) + enr
        pl = _lae(p[:, 1:], c)
        dp = torch.cat([dphi[:, :1], dphi[:, 1:] * torch.exp(p[:, 1:] - pl)], dim=1)
        dc = dphi[:, 1:] * torch.exp(c - pl)
        dphi_p = dp + torch.cat([dx, dx.new_zeros((b, 1))], dim=1)
        new_dphi = torch.cat([dphi_p[:, :1], dphi_p[:, 1:] * torch.exp(phi[:, 1:] - phi_p[:, 1:])],
                             dim=1)
        da = dphi_p[:, 1:] * torch.exp(a - phi_p[:, 1:])
        new_demit = dy + (dc + da)
        live = (s < lengths)[:, None]
        frame = log_probs.new_zeros((b, v)).scatter_add_(1, labels, dx + dy)
        frame[:, pad_id] += (dp + torch.cat([dc.new_zeros((b, 1)), dc], dim=1)).sum(1)
        grad[:, s] = torch.where(live, frame, torch.zeros_like(frame))
        dphi = torch.where(live, new_dphi, dphi)
        demit = torch.where(live, new_demit, demit)
    return grad


def supports(num_labels: int, num_classes: int, pad_id: int) -> bool:
    """What the kernels take: up to `MAX_LABELS` label positions a row, any
    number of classes, blank among them.  Outside it the wrappers raise on
    CUDA tensors."""
    return 0 <= num_labels <= MAX_LABELS and 0 <= pad_id < num_classes


# The plan's constants; `csrc/ctc.cu` checks what it is given against the
# same limits.
SMEM_LIMIT = 232448   # bytes of shared memory a block may use (H100)
MAX_THREADS = 576     # the kernels' __launch_bounds__
MAX_CHAIN_WARPS = 16
FWD_STAGES = 4        # log-prob chunks in flight (the producer's ring)
OUT_STAGES = 2        # staged chunks of states or cotangents (the storer's ring)
MAX_CHUNK = 16        # frames a chunk
FWD_BUDGET = 96 * 1024    # the forward's two rings, bytes
COEF_WARPS = {1: 12}  # coefficient warps of the backward by chain warps (else 6)
BWD_LANE_SLOTS = 8
COEF_BUDGET = 150 * 1024  # the backward's ring of coefficient frames, bytes
STAGE_BUDGET = 32 * 1024  # the backward's staged cotangents, bytes
SORT_BYTES = 8 * MAX_LABELS  # the backward's sort keys


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def fwd_smem_bytes(lane_slots, warps, num_labels, frames, stages, out_stages, stride) -> int:
    """Shared memory of a forward block (`fwd_layout` in `csrc/ctc.cu`):
    mbarriers, the labels, the warps' edge values, the log-prob ring, the
    staged states."""
    slots = 32 * lane_slots * warps
    return (_align16(8 * (2 * stages + 2 * out_stages)) + _align16(4 * num_labels)
            + _align16(4 * (2 * warps * lane_slots + 1)) + _align16(4 * stages * frames * stride)
            + 4 * out_stages * frames * 2 * slots)


def bwd_smem_bytes(warps, num_labels, coef_frames, frames, out_stages) -> int:
    """Shared memory of a backward block (`bwd_layout` in `csrc/ctc.cu`):
    mbarriers, each position's class and repeat rule, the edge values, the sort keys, the ring of
    coefficient frames (6 a position), the staged cotangents."""
    slots = 32 * BWD_LANE_SLOTS * warps
    return (_align16(8 * (2 * coef_frames + 2 * out_stages)) + _align16(4 * (num_labels + 1))
            + _align16(4 * 2 * warps * BWD_LANE_SLOTS) + SORT_BYTES
            + 4 * coef_frames * 6 * slots + 4 * out_stages * frames * 2 * slots)


@dataclass(frozen=True)
class Plan:
    """What the wrappers launch for N label positions and V classes.

    Forward: `fwd_lane_slots` (the instance, P) slots a lane in `fwd_warps`
    chain warps, chunks of `frames` frames, `stages` log-prob chunks of
    `stride` floats a frame (`bulk`: a chunk's V classes copied whole; else
    the row's L classes and the blank gathered, blank at 32 P W), states
    staged `out_stages` chunks deep.  Backward: 8 slots a lane in
    `bwd_warps` chain warps, the coefficient warps (`coef_warps`) in
    `coef_groups` groups that take frames in turn, a ring of `coef_frames` frames of
    coefficients, cotangents staged in chunks of `bwd_frames`."""

    fwd_lane_slots: int
    fwd_warps: int
    frames: int
    stages: int
    out_stages: int
    stride: int
    bulk: bool
    fwd_smem: int
    bwd_warps: int
    coef_groups: int
    coef_frames: int
    bwd_frames: int
    bwd_smem: int

    @property
    def fwd_threads(self) -> int:
        return 32 * (self.fwd_warps + 2)

    @property
    def coef_warps(self) -> int:
        return COEF_WARPS.get(self.bwd_warps, 6)

    @property
    def bwd_threads(self) -> int:
        # W = 1: the chain warp and the storer alone on sub-partition 0 (with
        # two warps that leave after the sort), 12 coefficient warps on 1-3
        return 32 * (16 if self.bwd_warps == 1 else self.bwd_warps + 1 + self.coef_warps)


def fwd_lane_slots(num_labels: int) -> int:
    """The forward's instance for N label positions: the slots a lane.  A
    frame's latency is two dependent log-add-exps whatever P is, but the
    compiler issues a lane's P slots mostly one after another, while the
    card interleaves warps for free: so one slot a lane while 16 warps hold
    the row (512 positions), then 2, 4, and 8 for 2049."""
    positions = num_labels + 1
    return 1 if positions <= 512 else 2 if positions <= 1024 else 4 if positions <= 2048 else 8


@functools.lru_cache(maxsize=None)
def plan(num_labels: int, num_classes: int, aligned: bool = True) -> Plan:
    """The kernels' plan for a label tensor of width N and V classes
    (`aligned`: the log-probs start on 16 bytes, so a chunk may be copied
    whole)."""
    lane_slots = fwd_lane_slots(num_labels)
    warps = -(-(num_labels + 1) // (32 * lane_slots))
    slots = 32 * lane_slots * warps
    bulk = aligned and num_classes % 4 == 0 and num_classes <= slots + 1
    stride = num_classes if bulk else slots + 1
    per_frame = 4 * (FWD_STAGES * stride + OUT_STAGES * 2 * slots)
    frames = max(1, min(MAX_CHUNK, FWD_BUDGET // per_frame))
    bwd_warps = -(-(num_labels + 1) // (32 * BWD_LANE_SLOTS))
    bwd_slots = 32 * BWD_LANE_SLOTS * bwd_warps
    coef_warps = COEF_WARPS.get(bwd_warps, 6)
    groups = next(g for g in range(coef_warps, 0, -1)
                  if coef_warps % g == 0 and (g == 1 or 2 * g * 24 * bwd_slots <= COEF_BUDGET))
    bwd_frames = max(1, min(MAX_CHUNK, STAGE_BUDGET // (OUT_STAGES * 2 * 4 * bwd_slots)))
    return Plan(lane_slots, warps, frames, FWD_STAGES, OUT_STAGES, stride, bulk,
                fwd_smem_bytes(lane_slots, warps, num_labels, frames, FWD_STAGES, OUT_STAGES,
                               stride),
                bwd_warps, groups, 2 * groups, bwd_frames,
                bwd_smem_bytes(bwd_warps, num_labels, 2 * groups, bwd_frames, OUT_STAGES))


def _kernel_inputs(name, log_probs, labels, logit_lengths, pad_id):
    _check(log_probs, labels, logit_lengths, pad_id)
    b, t, v = log_probs.shape
    if log_probs.dtype != torch.float32 or not log_probs.is_cuda:
        raise ValueError(f"{name} takes f32 CUDA log-probs, got {log_probs.dtype} on "
                         f"{log_probs.device}")
    if not supports(labels.shape[1], v, pad_id):
        raise ValueError(f"{name} takes at most {MAX_LABELS} label positions a row, got "
                         f"{labels.shape[1]}")
    dev = log_probs.device
    return (log_probs.contiguous(), labels.to(dev, torch.int32).contiguous(),
            logit_lengths.to(dev, torch.int32).contiguous())


def _plan_for(lp: torch.Tensor, num_labels: int) -> Plan:
    return plan(num_labels, lp.shape[2], lp.data_ptr() % 16 == 0)


def _launch_fwd(lp, lab, lengths, states, loss, pad_id, p: Plan) -> None:
    b, t, v = lp.shape
    _build.check("ctc_loss_fwd", _build.library().w2v2_ctc_fwd(
        lp.data_ptr(), lab.data_ptr(), lengths.data_ptr(), states.data_ptr(), loss.data_ptr(),
        b, t, v, lab.shape[1], pad_id, p.fwd_lane_slots, p.fwd_warps, p.frames, p.stages,
        p.out_stages, p.stride, int(p.bulk), _build.stream_of(lp)))


def ctc_loss_fwd(log_probs, labels, logit_lengths, pad_id: int = 0):
    """Kernel wrapper of `ctc_loss_fwd_plain` (states of frames at or past a
    row's length, and of label positions past its label count, are not
    written)."""
    if not log_probs.is_cuda:
        return ctc_loss_fwd_plain(log_probs, labels, logit_lengths, pad_id)
    lp, lab, lengths = _kernel_inputs("ctc_loss_fwd", log_probs, labels, logit_lengths, pad_id)
    b, t, v = lp.shape
    n = lab.shape[1]
    states = torch.empty((b, t, 2 * n + 1), dtype=torch.float32, device=lp.device)
    loss = torch.empty((b,), dtype=torch.float32, device=lp.device)
    if b == 0:
        return loss, states
    _launch_fwd(lp, lab, lengths, states, loss, pad_id, _plan_for(lp, n))
    ctc_loss_fwd.launches += 1
    return loss, states


ctc_loss_fwd.launches = 0


def ctc_loss_bwd(log_probs, labels, logit_lengths, states, grad_loss, pad_id: int = 0):
    """Kernel wrapper of `ctc_adjoint_plain`: two launches (the adjoint
    recursion, then the per-class sums), counted as one call."""
    if not log_probs.is_cuda:
        return ctc_adjoint_plain(log_probs, labels, logit_lengths, states, grad_loss, pad_id)
    lp, lab, lengths = _kernel_inputs("ctc_loss_bwd", log_probs, labels, logit_lengths, pad_id)
    b, t, v = lp.shape
    n = lab.shape[1]
    if states.shape != (b, t, 2 * n + 1) or states.dtype != torch.float32:
        raise ValueError(f"ctc_loss_bwd: states {tuple(states.shape)} for {b, t, 2 * n + 1}")
    dev = lp.device
    g = grad_loss.to(dev, torch.float32).contiguous()
    dl = torch.empty_like(states)                 # each state's cotangent a frame
    order = torch.empty((b, n), dtype=torch.int32, device=dev)       # positions by class
    offsets = torch.empty((b, v + 1), dtype=torch.int32, device=dev)
    blank = torch.empty((b, t), dtype=torch.float32, device=dev)    # the blank's sum a frame
    grad = torch.empty_like(lp)
    if b == 0:
        return grad
    p = _plan_for(lp, n)
    _build.check("ctc_loss_bwd", _build.library().w2v2_ctc_bwd(
        lp.data_ptr(), lab.data_ptr(), lengths.data_ptr(), states.contiguous().data_ptr(),
        g.data_ptr(), dl.data_ptr(), order.data_ptr(), offsets.data_ptr(), blank.data_ptr(),
        grad.data_ptr(), b, t, v, n, pad_id, p.bwd_warps, p.coef_groups, p.coef_frames,
        p.bwd_frames, p.out_stages, _build.stream_of(lp)))
    ctc_loss_bwd.launches += 1
    return grad


ctc_loss_bwd.launches = 0


def chain_step_ms(backward: bool, iters: int = 20000) -> float:
    """Device ms of one step of a frame's critical path on the card (the
    forward's: a shuffle, an add, a log-add-exp, an add, a log-add-exp; the
    backward's: a mul, an add, a mul, an add, a shuffle, an add), `iters`
    dependent steps in one warp timed by CUDA events: the chain bound of a
    row is its frames times this."""
    dev = torch.device("cuda")
    x = torch.linspace(-3.0, -1.0, 128, device=dev)
    out = torch.empty(32, device=dev)
    lib = _build.library()

    def run(n):
        _build.check("ctc_chain_probe", lib.w2v2_ctc_chain_probe(
            x.data_ptr(), out.data_ptr(), n, int(backward), _build.stream_of(x)))

    run(iters)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(iters)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def log1p_mismatches() -> int:
    """The floats in [0, 1] where the kernels' branch-free log1p and the
    CUDA math library's `log1pf` differ in any bit (0: the kernels compute
    the plain version's log-add-exp exactly), counted on the card."""
    bad = torch.zeros(1, dtype=torch.int32, device="cuda")
    _build.check("ctc_log1p_check", _build.library().w2v2_ctc_log1p_check(
        bad.data_ptr(), _build.stream_of(bad)))
    return int(bad.item())


class CTCLoss(torch.autograd.Function):
    """The kernels under autograd: the forward saves the per-frame states,
    the backward is `ctc_loss_bwd` scaled by each row's cotangent."""

    @staticmethod
    def forward(ctx, log_probs, labels, logit_lengths, pad_id: int):
        loss, states = ctc_loss_fwd(log_probs, labels, logit_lengths, pad_id)
        ctx.save_for_backward(log_probs, labels, logit_lengths, states)
        ctx.pad_id = pad_id
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        log_probs, labels, logit_lengths, states = ctx.saved_tensors
        grad = ctc_loss_bwd(log_probs, labels, logit_lengths, states, grad_loss, ctx.pad_id)
        return grad, None, None, None


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor,
             pad_id: int = 0) -> torch.Tensor:
    """(B,) per-row CTC loss of f32 log-probs: `ctc_loss_plain` for CPU
    tensors; `CTCLoss` over the kernels for CUDA ones (a ValueError outside
    `supports`)."""
    if not log_probs.is_cuda:
        return ctc_loss_plain(log_probs, labels, logit_lengths, pad_id)
    lengths = torch.as_tensor(logit_lengths).to(log_probs.device)
    return CTCLoss.apply(log_probs, labels, lengths, int(pad_id))
