"""The port's kernel dispatch, on the CPU.

Where a config falls outside a kernel's instances the card takes the plain
torch op, as the JAX package takes XLA's (`supports` at each site); the
plain ops taken there must be the same functions, with the same gradients,
as the kernels' definitions.  Also the host-side mirror of the conv
front-end kernels: the cluster partition of `groupnorm_stats`, and its plain
version against conv0 in float64.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from tests.utils import tiny_config

from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend, flash_attention, pos_conv

torch.set_num_threads(2)


def _port(robust=False, **kw):
    cls = port_config.RobustWav2Vec2Config if robust else port_config.Wav2Vec2Config
    return cls(**{**dataclasses.asdict(tiny_config(robust=robust)), **kw})


# (name, config): tiny_config is the JAX tests' geometry; "huge" is hidden
# 1280 with 16 heads and 16 pos-conv groups (D = 80: no flash instance, as
# JAX's d % 64 rule; C/G = 80: the pos-conv kernels' 80-channel instances);
# "xls_r_2b" is hidden 1920 (D = 120, C/G = 120); "base_384" and
# "robust_c1024" have front ends of 384 and 1024 channels (the conv01
# kernels' narrow and wide instances); "base_g8" and "robust_g8" have 8
# pos-conv groups (C/G = 96 and 128)
CONFIGS = {
    "tiny": lambda: _port(),
    "tiny_robust": lambda: _port(robust=True),
    "base": lambda: port_config.Wav2Vec2Config(),
    "robust": lambda: port_config.RobustWav2Vec2Config(),
    "huge": lambda: port_config.RobustWav2Vec2Config(hidden_size=1280, num_heads=16,
                                                     intermediate_size=5120),
    "xls_r_2b": lambda: port_config.RobustWav2Vec2Config(hidden_size=1920, num_heads=16,
                                                         intermediate_size=7680),
    "base_384": lambda: port_config.Wav2Vec2Config(filter_sizes=[384] * 7),
    "robust_c1024": lambda: port_config.RobustWav2Vec2Config(filter_sizes=[1024] * 7),
    "base_g8": lambda: port_config.Wav2Vec2Config(num_conv_pos_embedding_groups=8),
    "robust_g8": lambda: port_config.RobustWav2Vec2Config(num_conv_pos_embedding_groups=8),
    "base_g32": lambda: port_config.Wav2Vec2Config(num_conv_pos_embedding_groups=32),
    "robust_g128": lambda: port_config.RobustWav2Vec2Config(num_conv_pos_embedding_groups=128),
}

# per config: (conv front end, pos conv in bf16, flash in bf16)
COVERED = {
    "tiny": (False, False, False),
    "tiny_robust": (False, False, False),
    "base": (True, True, True),
    "robust": (True, True, True),
    "huge": (True, True, False),
    "xls_r_2b": (True, True, False),
    "base_384": (True, True, True),
    "robust_c1024": (True, True, True),
    "base_g8": (True, True, True),
    "robust_g8": (True, True, True),
    "base_g32": (True, True, True),
    "robust_g128": (True, True, True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_site_supports_exactly_the_kernel_instances(name):
    cfg = CONFIGS[name]()
    conv, pos, attn = COVERED[name]
    h, g = cfg.hidden_size, cfg.num_conv_pos_embedding_groups
    assert conv_frontend.supports(cfg) is conv
    # the plain versions of the fused pair (the CPU) take any width
    assert conv_frontend.fusable(cfg)
    assert pos_conv.supports(h, g, torch.bfloat16, cfg.num_conv_pos_embeddings) is pos
    assert flash_attention.supports(h // cfg.num_heads, torch.bfloat16) is attn


@pytest.mark.parametrize("name", list(CONFIGS))
def test_f32_takes_no_kernel(name):
    """In f32 the pos conv takes no kernel (JAX runs it bf16-only too); flash
    takes its f32 kernels exactly where the head dim is 64, 128, 192 or 256,
    as JAX runs its dtype-generic Pallas kernels on f32 inputs."""
    cfg = CONFIGS[name]()
    h, g = cfg.hidden_size, cfg.num_conv_pos_embedding_groups
    assert not pos_conv.supports(h, g, torch.float32, cfg.num_conv_pos_embeddings)
    d = h // cfg.num_heads
    assert flash_attention.supports(d, torch.float32) is (d in (64, 128, 192, 256))


@pytest.mark.parametrize("c,groups,k,ok", [(768, 16, 128, True), (1024, 16, 128, True),
                                           (256, 16, 128, True), (1024, 16, 36, True),
                                           (768, 16, 36, False), (768, 16, 127, False),
                                           (768, 8, 128, True), (770, 16, 128, False),
                                           (1920, 16, 128, True), (1920, 16, 36, True),
                                           (1920, 16, 130, False), (1920, 16, 136, False),
                                           (1920, 15, 128, True), (1920, 14, 128, False), (512, 16, 128, True),
                                           (1536, 16, 128, True), (1792, 16, 128, True),
                                           (2048, 16, 128, True), (1024, 8, 128, True),
                                           (2048, 16, 132, True), (2048, 16, 136, False),
                                           (1792, 16, 264, True), (1792, 16, 268, False),
                                           (384, 16, 128, True), (640, 16, 128, True),
                                           (2304, 16, 128, False), (1536, 16, 36, True),
                                           (960, 16, 128, False)])
def test_pos_conv_supports_taps_and_groups(c, groups, k, ok):
    """C/G in the instances (every multiple of 8 up to 128: 24 and 40, not
    60 or 144), a tap count the dW kernel's tap blocks divide (8 at 8, 16,
    40, 48 and 80 channels a group, else 4), and a window the forward's
    shared memory holds (up to 132 taps at 120 and 128, 264 at 104 and
    112).  768 in 8 groups is C/G = 96 and 1920 in 15 is C/G = 128."""
    assert pos_conv.supports(c, groups, torch.bfloat16, k) is ok


@pytest.mark.parametrize("width", [128 * k for k in range(1, 9)] + [192, 200, 1152, 1280])
@pytest.mark.parametrize("robust", [False, True])
def test_conv_frontend_supports_the_multiples_of_128_up_to_1024(robust, width):
    """The card takes the conv01 kernels at every multiple of 128 from 128 to
    1024 in both families (JAX's Pallas rule, capped at 1024: past it the
    plain layer loop, a deliberate difference); elsewhere the plain loop, as
    JAX's XLA fallback.  The plain versions (the CPU) take any width."""
    family = port_config.RobustWav2Vec2Config if robust else port_config.Wav2Vec2Config
    cfg = family(filter_sizes=[width] * 7)
    assert conv_frontend.fusable(cfg)
    assert conv_frontend.supports(cfg) is (width % 128 == 0 and width <= 1024)


def _conv01_launches():
    """The widths `launch_conv01` in `csrc/conv_frontend.cu` dispatches to an
    instance (`case C: return launch_conv<C, kLayer>`)."""
    src = (pathlib.Path(conv_frontend.__file__).parents[2] / "csrc" / "conv_frontend.cu").read_text()
    entry = src[src.index("cudaError_t launch_conv01("):]
    entry = entry[:entry.index("\n}\n")]
    found = re.findall(r"case (\d+): return launch_conv<(\d+), kLayer>", entry)
    assert all(case == c for case, c in found)
    return [int(c) for _, c in found]


def test_conv01_widths_are_the_cuda_instances():
    """`KERNEL_WIDTHS` (what `supports` and the wrappers admit) is exactly
    the set of widths the C entry dispatches, each once."""
    launched = _conv01_launches()
    assert len(launched) == len(set(launched))
    assert set(launched) == set(conv_frontend.KERNEL_WIDTHS)


def _switch(source: str, head: str) -> str:
    """The body of the function of `csrc/<source>` that starts with `head`."""
    src = (pathlib.Path(pos_conv.__file__).parents[2] / "csrc" / source).read_text()
    entry = src[src.index(head):]
    return entry[:entry.index("\n}\n")]


# the C entry points' switches (multiples of 16 and 120) send every other
# C/G to the odd multiples of 8's switches in `csrc/pos_conv_odd8.cu`
DW_SWITCHES = (("pos_conv.cu", 'extern "C" int w2v2_pos_conv_dw'), ("pos_conv_odd8.cu", "int dw_odd8("))
FORWARD_SWITCHES = (("pos_conv.cu", "int dispatch("), ("pos_conv_odd8.cu", "int dispatch_odd8("))


def _dw_launches():
    """C/G -> (kTapStep, kTaps, kNSplit) of each `launch_dw<CG, kTapStep,
    kTaps, kNSplit>` instance that `w2v2_pos_conv_dw` in `csrc/pos_conv.cu`
    and `dw_odd8` in `csrc/pos_conv_odd8.cu` dispatch to."""
    launches = {}
    for source, head in DW_SWITCHES:
        entry = _switch(source, head)
        found = re.findall(r"case (\d+): return \(int\)launch_dw<(\d+), (\d+), (\d+), (\d+)>", entry)
        assert all(case == cg for case, cg, *_ in found)
        assert len(found) == entry.count("case ")
        assert not launches.keys() & {int(cg) for _, cg, *_ in found}
        launches.update({int(cg): (int(step), int(taps), int(split))
                         for _, cg, step, taps, split in found})
    return launches


def _forward_launches():
    """The C/G that the forward / dx switches (`dispatch` in
    `csrc/pos_conv.cu`, `dispatch_odd8` in `csrc/pos_conv_odd8.cu`) send to
    a `launch<CG, kMode>` instance."""
    launched = []
    for source, head in FORWARD_SWITCHES:
        entry = _switch(source, head)
        found = re.findall(r"case (\d+): return \(int\)launch<(\d+), kMode>", entry)
        assert all(case == cg for case, cg in found) and len(found) == entry.count("case ")
        launched += [int(cg) for _, cg in found]
    return launched


def test_both_c_switches_dispatch_exactly_the_widths():
    """The forward / dx switch and the dW switch hold one case for each
    `pos_conv.WIDTHS` entry, and those are every multiple of 8 up to 128:
    what `supports` admits in bf16 at 128 taps, for every C/G up to 160."""
    fwd = _forward_launches()
    assert len(fwd) == len(set(fwd)) and set(fwd) == set(_dw_launches()) == set(pos_conv.WIDTHS)
    rule = {cg for cg in range(1, 161) if cg % 8 == 0 and cg <= 128}
    assert set(pos_conv.WIDTHS) == rule == set(range(8, 129, 8))
    for cg in range(1, 161):
        assert pos_conv.supports(16 * cg, 16, torch.bfloat16, 128) is (cg in rule)


def _dw_instances():
    """C/G -> the tap counts each dW instance takes are multiples of (its kTapStep)."""
    return {cg: step for cg, (step, _, _) in _dw_launches().items()}


def test_dw_tap_rule_is_the_cuda_instances():
    """`pos_conv.supports` and `pos_conv_dw` share one tap rule, and it is the
    C entry's: the same C/G widths, the same taps a block, each dividing 16
    (so every tap count JAX's Pallas kernels take)."""
    assert _dw_instances() == {cg: w.tap_step for cg, w in pos_conv.WIDTHS.items()}
    assert all(16 % step == 0 for step in _dw_instances().values())


def test_dw_cta_taps_are_the_cuda_instances():
    """`dw_splits` counts the dW kernel's tap blocks with the C entry's taps a
    CTA (kTaps) and output-channel shares (kNSplit), and each block is a
    whole number of 128-row warpgroup halves of `dw_tap_rows` M rows a tap
    (C/G, padded to whole 16-row slabs at the odd multiples of 8, 128 at
    120, and past the slab to 128 at 72's 4 taps, 104's 3 and 112's 4)."""
    assert {cg: (taps, split) for cg, (_, taps, split) in _dw_launches().items()} == {
        cg: (w.dw_taps, w.dw_n_split) for cg, w in pos_conv.WIDTHS.items()}
    for cg, w in pos_conv.WIDTHS.items():
        assert w.dw_taps * pos_conv.dw_tap_rows(cg, w.dw_taps) % 128 == 0
    rows = {cg: pos_conv.dw_tap_rows(cg, w.dw_taps) for cg, w in pos_conv.WIDTHS.items()}
    assert [cg for cg in pos_conv.WIDTHS if rows[cg] != cg] == [8, 24, 40, 56, 72, 88, 104, 112, 120]
    assert [cg for cg in pos_conv.WIDTHS if rows[cg] != pos_conv.tap_rows(cg)] == [72, 104, 112]


@pytest.mark.parametrize("cg", sorted(pos_conv.WIDTHS))
@pytest.mark.parametrize("k", [4, 8, 12, 36, 128])
def test_pos_conv_supports_exactly_the_taps_the_dw_kernel_takes(cg, k):
    """A tap count passes `supports` at C/G = cg exactly when the dW
    instance's tap blocks divide it, so no admitted config reaches a
    wrapper that refuses it."""
    taps = _dw_instances()[cg]
    assert pos_conv.supports(4 * cg, 4, torch.bfloat16, k) is (k % taps == 0)


@pytest.mark.parametrize("length", [24000, 246000, 1_920_000, 24007])
def test_window_stats_partials_sum_in_block_order_to_the_plain_sums(length):
    """The stats kernel's cluster partition (8 CTAs a batch row, chunks
    staged at multiples of 80 samples with the B windows' 5-sample halo,
    masked tails) and its rank-order sum give `window_stats_plain`: every
    window is counted once, and no window reads a sample that was not
    staged (those read as NaN in the model)."""
    rng = np.random.default_rng(length)
    x = torch.from_numpy(rng.standard_normal((2, length)).astype(np.float32)).to(torch.bfloat16)
    t0 = conv_frontend.conv0_length(length)
    ld = -(-length // 8) * 8
    cuts = conv_frontend.stats_partition(t0, ld)
    assert len(cuts) == conv_frontend.STATS_CLUSTER
    na, nb = (t0 + 1) // 2, t0 // 2
    pairs = [r0 + i for rank in cuts for r0, n, _, _ in rank for i in range(n)]
    assert pairs == list(range(na))  # every window pair once, in rank order
    for rank in cuts:
        for r0, n, s0, staged in rank:
            assert r0 % 8 == 0 and s0 == 10 * r0 and s0 % 80 == 0
            assert n <= conv_frontend.STATS_CHUNK_ROWS and staged % 8 == 0  # 16-byte copies
            # the chunk holds its A windows and, where unmasked, its B windows' halo
            assert staged >= min(10 * n, length - s0)
            if r0 + n - 1 < nb:
                assert staged >= 10 * n + 5
    part = conv_frontend.groupnorm_stats_partials(x, t0)
    assert part.shape == (2, conv_frontend.STATS_CLUSTER, 65) and torch.isfinite(part).all()
    total = part[:, 0]
    for k in range(1, conv_frontend.STATS_CLUSTER):
        total = total + part[:, k]
    gram, row_sum = conv_frontend.window_stats_plain(x, t0)
    j, k = torch.triu_indices(10, 10)
    scale = gram.abs().max().item()
    assert (total[:, :55] - gram[:, j, k]).abs().max().item() <= 1e-5 * scale
    assert (total[:, 55:] - row_sum).abs().max().item() <= 1e-5 * scale
    # every window once: all-ones samples count t0 windows in each sum
    ones = conv_frontend.groupnorm_stats_partials(torch.ones_like(x), t0).sum(dim=1)
    assert torch.equal(ones, torch.full_like(ones, float(t0)))


@pytest.mark.parametrize("length", [16000, 24007])
def test_groupnorm_stats_plain_matches_a_float64_conv0(length):
    """`groupnorm_stats_plain` (window statistics, then the folded affine
    map) against conv0 computed directly in float64 and its per-channel
    mean and variance over time, at 1e-5 of each output's scale."""
    rng = np.random.default_rng(length)
    c, eps = 64, 1e-5
    wave = (rng.standard_normal((2, length)) + 0.2).astype(np.float32)
    w0 = (rng.standard_normal((10, 1, c)) * 0.3).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    x = torch.from_numpy(wave).to(torch.bfloat16)
    t0 = conv_frontend.conv0_length(length)
    scale, shift = conv_frontend.groupnorm_stats_plain(
        x, t0, torch.from_numpy(w0), torch.from_numpy(gamma), torch.from_numpy(beta), eps)
    xd = x.double().numpy()
    win = np.stack([xd[:, 5 * t: 5 * t + 10] for t in range(t0)], axis=1)  # (2, t0, 10)
    y = win @ w0.reshape(10, c).astype(np.float64)  # conv0, (2, t0, C)
    want_scale = gamma / np.sqrt(y.var(axis=1) + eps)
    want_shift = beta - y.mean(axis=1) * want_scale
    for got, want in ((scale, want_scale), (shift, want_shift)):
        assert got.shape == (2, c) and got.dtype == torch.float32
        assert np.abs(got.double().numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_pos_conv_plain_fallback_has_the_kernels_gradients():
    """The plain pos conv that the card takes outside the instances, through
    autograd, gives the `PosConvTrain` function's output and gradients."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 64, generator=g, requires_grad=True)
    kernel = (0.1 * torch.randn(16, 4, 64, generator=g)).requires_grad_()
    bias = torch.randn(64, generator=g, requires_grad=True)
    dy = torch.randn(2, 40, 64, generator=g)
    grads = []
    for fn in (lambda: pos_conv.pos_conv_plain(x, kernel, bias, groups=16, gelu_approx=False),
               lambda: pos_conv.PosConvTrain.apply(x, kernel, bias, 16, False)):
        y = fn()
        grads.append((y.detach(),) + torch.autograd.grad(y, (x, kernel, bias), dy))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_plain_fallback_has_the_kernels_gradients(rate):
    """The plain attention that the card takes outside the instances, through
    autograd, gives `FlashAttention`'s output and gradients, hash dropout
    bits included.

    In float64: the two backwards are two formulas of one gradient (autograd
    through logsumexp and exp against p * (dp - delta)), so they differ in
    rounding only.  In f32 that difference reached half of the former
    tolerance (dq 5.2e-6 of atol 1e-5, values up to 17.7) and moved with the
    CPU's blocking of the products, which the load of other processes
    changes.  In f64 each value is a sum of at most 2L = 100 products of
    magnitude below 20, so the two differ by at most about 100 * 20 * 2.2e-16
    = 4.4e-13 (1.1e-14 measured): held at atol 1e-12, rtol 0."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 4, 50, 16, generator=g).double().requires_grad_(True)
               for _ in range(3))
    bias = torch.zeros(2, 50)
    bias[1, 37:] = -10000.0
    dout = torch.randn(2, 4, 50, 16, generator=g).double()
    grads = []
    for fn in (lambda: flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=rate,
                                                                 seed=7)[0],
               lambda: flash_attention.flash_attention(q, k, v, bias, dropout_rate=rate, seed=7)):
        out = fn()
        grads.append((out.detach(),) + torch.autograd.grad(out, (q, k, v), dout))
    for a, b in zip(*grads):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
