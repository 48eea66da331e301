"""Times the port's hand-written kernels on one NVIDIA GPU.

    python3 flash_bench.py [--family flash|flash_f32|conv|pos_conv|scatter|ctc|forward] [--root DIR] [--label NAME]

`--family flash` (the default): at each shape of the main paths (base
inference, base training, robust, long; head dim 64), of the robust widths
at 8 heads of 128 ((8, 8, 768, 128) without and with dropout 0.1, (1, 8,
5999, 128) with it), of the base widths at 4 heads of 192 ((16, 4, 768,
192), the same two ways, and (1, 4, 5999, 192)) and of the robust widths at
4 heads of 256 ((8, 4, 768, 256), (1, 4, 5999, 256)), the forward and the
backward wrappers of
`gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention`, and
`scaled_dot_product_attention` with the same mask and dropout rate; and the
wrappers' host time a call at a tiny shape.  Under `--root`, a head dim
that tree's `flash_attention.supports` does not take prints a skipped row.

`--family flash_f32`: the same wrappers in f32 (`--compute_dtype float32`,
TF32 off), each shape with a ragged key bias, unit-scale inputs (q with the
model's D^-1/2): the robust widths at 8 heads of 128 ((8, 8, 768, 128)), the
base widths at 4 heads of 192 ((16, 4, 768, 192)) and the robust widths at 4
heads of 256 ((8, 4, 768, 256)), each without and with dropout 0.1, and the
long regime (1, H, 5999, D) with it; head dim 64 at (16, 12, 768, 64), both
ways, and (1, 12, 5999, 64).  Beside them `scaled_dot_product_attention` in
f32 with the same mask and rate.  Under `--root`, a head dim that tree's
`flash_attention.supports` does not take in f32 prints a skipped row.

`--family conv`: the conv front-end kernels of
`gsoc_wav2vec2_tpu_torch.ops.kernels.conv_frontend` at the main paths'
shapes (x 246000 samples): GroupNorm's scale and shift at B=16 and at 1 x
1,920,000 (`groupnorm_stats`; in a tree that predates it, `window_stats`
followed by the torch glue `groupnorm_scale_shift`, which it replaced),
`conv01` (the base family) at B=16 (inference) and B=32 (training),
`conv01_robust` at B=8, all at C = 512; both at C = 256 (B=16, B=8), 384
(the base_c384 cell's B=16) and 1024 (the robust_c1024 cell's B=8).  Under
`--root`, a width that tree's `conv_frontend.KERNEL_WIDTHS` does not hold
prints a skipped row.

`--family pos_conv`: the four wrappers of
`gsoc_wav2vec2_tpu_torch.ops.kernels.pos_conv` at T = 768 frames (246000
samples) and K = 128 taps: base (C = 768, 16 groups) `pos_conv` at B=16 and
`pos_conv_train_fwd`, `pos_conv_dx`, `pos_conv_dw` at B=32; robust/large
(C = 1024, C/G = 64), the 1280-d family (C/G = 80), XLS-R 2B (C = 1920,
C/G = 120) and C/G = 32, 96, 112 and 128 (C = 512 ... 2048, 16 groups) and
the odd multiples of 8, 8 ... 104 (C = 128 ... 1664, 16 groups), all four
at B=8, and `pos_conv` at 80, 120 and 128 also at 32 and 64 taps (a
launch's fixed cost against its cost a tap).  Under `--root`,
a width that tree's `pos_conv.supports` does not cover prints a skipped row;
in this tree it fails.

`--family scatter`: `scatter_rows_add` of
`gsoc_wav2vec2_tpu_torch.ops.kernels.scatter_add` at the pretraining
recipe's (8, 768 x 100, D) -> 768 rows, D = 256 and 768, f32 and bf16, on
the indices the package's negative sampler gives a ragged masked batch (row
0 hot) and on uniform indices, with the device ms of each kernel of the call.

`--family ctc`: the CTC wrappers of
`gsoc_wav2vec2_tpu_torch.ops.kernels.ctc` (forward; backward = the adjoint
and the per-class sums) at the recipe's 32 x 768 frames, a data-2 rank's 16
x 768 (V = 32, labels 50-200, pad 0, a quarter of the rows cut to 400-768
frames), the long cell's 1 x 5999 and a subword vocabulary's 4 x 400 at
V = 8192; beside them `F.ctc_loss`'s forward and its backward alone
(`zero_infinity`, a yardstick the port never calls), each call's kernels
by the profiler; and, where the tree has it, the chain bound: the longest
row's frames times one frame's critical path timed on the card
(`chain_step_ms`), and the kernels' registers and spills.

`--family forward`: the base model's bf16 forward (`Wav2Vec2Config()`, seeded
weights) at B=16 x 246000: ms per forward (host clock around a forward that
ends in a synchronize, median of 20), and by the profiler over 3 forwards the
kernel launches and device busy ms per forward.

Each time is device ms a call by CUDA events around a back-to-back run after
warm-up (a device sleep ahead of it keeps the host's wrapper work out), and
by the profiler (flash: every kernel of the call; conv, pos_conv, scatter:
the call's largest kernel, named, and every kernel of the call).  `--root` imports the package from another checkout, so
that two trees are compared on one card in one run (parent, change, change,
parent).  Prints one JSON line per shape, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def events_ms(torch, fn, iters):
    """Device ms of one call: CUDA events around `iters` back-to-back calls
    after 3 warm-up calls, behind a device sleep that holds the stream while
    the host enqueues the run."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(iters * 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_rows(torch, fn, reps):
    """The profiler's device events by kernel over `reps` calls of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def profiled_ms(torch, fn, reps):
    """(device ms a call of every kernel, of the largest kernel, its name)
    by the profiler over `reps` calls; None for each where the trace holds
    no kernel (the profiler drops a window's records now and then), so the
    events' time of the row is kept."""
    rows = profiled_rows(torch, fn, reps)
    if not rows:
        return None, None, None
    top = max(rows, key=lambda e: e.self_device_time_total)
    return (sum(e.self_device_time_total for e in rows) / 1e3 / reps,
            top.self_device_time_total / 1e3 / reps, top.key[:80])


# (B, H, L, D, dropout rate, ragged key bias) of `--family flash` (bf16) and
# `--family flash_f32`
FLASH_SHAPES = ((16, 12, 768, 64, 0.0, False), (32, 12, 768, 64, 0.1, True),
                (8, 16, 768, 64, 0.0, True), (8, 16, 768, 64, 0.1, True),
                (1, 12, 5999, 64, 0.1, True), (8, 8, 768, 128, 0.0, True),
                (8, 8, 768, 128, 0.1, True), (1, 8, 5999, 128, 0.1, True),
                (16, 4, 768, 192, 0.0, True), (16, 4, 768, 192, 0.1, True),
                (1, 4, 5999, 192, 0.1, True), (8, 4, 768, 256, 0.0, True),
                (8, 4, 768, 256, 0.1, True), (1, 4, 5999, 256, 0.1, True))
F32_SHAPES = ((8, 8, 768, 128, 0.0, True), (8, 8, 768, 128, 0.1, True), (16, 4, 768, 192, 0.0, True),
              (16, 4, 768, 192, 0.1, True), (8, 4, 768, 256, 0.0, True), (8, 4, 768, 256, 0.1, True),
              (1, 8, 5999, 128, 0.1, True), (1, 4, 5999, 192, 0.1, True), (1, 4, 5999, 256, 0.1, True),
              (16, 12, 768, 64, 0.0, True), (16, 12, 768, 64, 0.1, True), (1, 12, 5999, 64, 0.1, True))


def flash_rows(torch, label, dtype, shapes, score_std, iters, reps):
    """One row a shape: the flash forward and backward wrappers in `dtype`
    and `scaled_dot_product_attention` with the same mask and rate (q scaled
    to scores of std ~`score_std`), events over `iters` calls and the
    profiler's device ms over `reps`, for the wrappers also by kernel."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(0)
    for b, h, l, d, rate, ragged in shapes:
        row = {"label": label, "dtype": str(dtype).split(".")[-1], "shape": [b, h, l, d], "dropout": rate,
               "ragged_bias": ragged}
        if not fa.supports(d, dtype):
            print(json.dumps({**row, "skipped": "the tree's flash_attention.supports does not take it"}),
                  flush=True)
            continue
        q, k, v, dout = (torch.randn(b, h, l, d, generator=gen).cuda().to(dtype) for _ in range(4))
        q = q * (score_std / d ** 0.5)
        bias, mask = None, None
        if ragged:
            lengths = torch.randint(l // 4, l + 1, (b,), generator=gen)
            bias = torch.where(torch.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).cuda()
            mask = bias[:, None, None, :].to(q.dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, bias, dropout_rate=rate, seed=1)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = sdpa(qg, kg, vg, attn_mask=mask, dropout_p=rate, scale=1.0)
        fns = {
            "fwd": lambda: fa.flash_attention_fwd(q, k, v, bias, dropout_rate=rate, seed=1),
            "bwd": lambda: fa.flash_attention_bwd(q, k, v, bias, out, lse, dout, dropout_rate=rate, seed=1),
            "sdpa_fwd": lambda: sdpa(q, k, v, attn_mask=mask, dropout_p=rate, scale=1.0),
            "sdpa_bwd": lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True),
        }
        for name, fn in fns.items():
            row[name + "_ms"] = events_ms(torch, fn, iters)
            rows = profiled_rows(torch, fn, reps)
            row[name + "_device_ms"] = sum(e.self_device_time_total for e in rows) / 1e3 / reps if rows else None
            if name in ("fwd", "bwd"):  # the wrapper's kernels apart, under their full names
                row[name + "_kernels_ms"] = {e.key: e.self_device_time_total / 1e3 / reps for e in rows}
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, qg, kg, vg, lib_out
        torch.cuda.empty_cache()


def bench_flash(torch, label):
    from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa

    flash_rows(torch, label, torch.bfloat16, FLASH_SHAPES, 2.0, 50, 10)
    # the wrappers' host time a call, where the device is not the limit
    gen = torch.Generator().manual_seed(1)
    q, k, v, dout = (torch.randn(1, 1, 64, 64, generator=gen).cuda().to(torch.bfloat16)
                     for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    row = {"label": label, "host_us_per_call_at": [1, 1, 64, 64]}
    for name, fn in (("fwd", lambda: fa.flash_attention_fwd(q, k, v)),
                     ("bwd", lambda: fa.flash_attention_bwd(q, k, v, None, out, lse, dout))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(500):
            fn()
        row[name + "_host_us"] = (time.perf_counter() - t) / 500 * 1e6
        torch.cuda.synchronize()
    print(json.dumps(row), flush=True)


def bench_flash_f32(torch, label):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_rows(torch, label, torch.float32, F32_SHAPES, 1.0, 20, 5)


def front_params(torch, c: int, robust: bool, gen, dev):
    """Random conv front-end weights at width c on the model's glorot-uniform
    scale, and random norm affines (and biases): robust (w0, b0, g0, e0, w1,
    b1, g1, e1), base (w0, gamma, beta, w1).  `chip_smoke.py` holds the
    instances against their plain versions on the same weights."""
    uniform = lambda shape, limit: ((torch.rand(shape, generator=gen) * 2 - 1) * limit).to(dev)
    w0 = uniform((10, 1, c), (6 / (10 * (1 + c))) ** 0.5)
    w1 = uniform((3, c, c), c ** -0.5)
    vec = lambda scale, offset: (offset + scale * torch.randn(c, generator=gen)).to(dev)
    if robust:
        return (w0, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0), w1, vec(0.1, 0.0), vec(0.1, 1.0),
                vec(0.1, 0.0))
    return w0, vec(0.1, 1.0), vec(0.1, 0.0), w1


def bench_conv(torch, label):
    from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend as cf

    gen = torch.Generator().manual_seed(0)
    weights = {}

    def at_width(c):
        if c not in weights:
            w0, gamma, beta, w1 = front_params(torch, c, False, gen, "cuda")
            weights[c] = w0, w1, gamma, beta, front_params(torch, c, True, gen, "cuda")
        return weights[c]

    for name, c, b, samples in (("stats", 512, 16, 246000), ("stats", 512, 1, 1_920_000),
                                ("conv01", 512, 16, 246000), ("conv01", 512, 32, 246000),
                                ("conv01_robust", 512, 8, 246000), ("conv01", 256, 16, 246000),
                                ("conv01_robust", 256, 8, 246000), ("conv01", 384, 16, 246000),
                                ("conv01_robust", 1024, 8, 246000)):
        if name != "stats" and c not in getattr(cf, "KERNEL_WIDTHS", (512, 256)):
            print(json.dumps({"label": label, "kernel": name, "width": c, "shape": [b, samples],
                              "skipped": "the tree's conv_frontend.KERNEL_WIDTHS does not hold it"}),
                  flush=True)
            continue
        w0, w1, gamma, beta, robust = at_width(c)
        x = torch.randn(b, samples, generator=gen).cuda().to(torch.bfloat16)
        t0, t1 = cf.conv0_length(samples), cf.conv1_length(samples)
        if name == "stats" and hasattr(cf, "groupnorm_stats"):
            name = "groupnorm_stats"
            fn = lambda: cf.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
        elif name == "stats":  # the two-launch kernel and the glue it fed
            name = "window_stats+groupnorm_scale_shift"
            fn = lambda: cf.groupnorm_scale_shift(*cf.window_stats(x, t0), w0, gamma, beta, t0, 1e-5)
        elif name == "conv01":
            gram, rsum = cf.window_stats_plain(x, t0)
            scale, shift = cf.groupnorm_scale_shift(gram, rsum, w0, gamma, beta, t0, 1e-5)
            fn = lambda: cf.conv01(x, w0, scale, shift, w1, t1, True)
        else:
            fn = lambda: cf.conv01_robust(x, *robust, t1, 1e-5, True)
        row = {"label": label, "kernel": name, "width": c, "shape": [b, samples],
               "ms": events_ms(torch, fn, 50)}
        row["call_device_ms"], row["device_ms"], row["device_kernel"] = profiled_ms(torch, fn, 5)
        print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()


def bench_pos_conv(torch, label, other_tree=False):
    from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv as pc

    gen = torch.Generator().manual_seed(0)
    t = 768
    b8 = (("pos_conv", 8, 128), ("pos_conv_train_fwd", 8, 128), ("pos_conv_dx", 8, 128),
          ("pos_conv_dw", 8, 128))
    taps = (("pos_conv", 8, 32), ("pos_conv", 8, 64))
    for c, cg, cases in ((768, 48, (("pos_conv", 16, 128), ("pos_conv_train_fwd", 32, 128),
                                    ("pos_conv_dx", 32, 128), ("pos_conv_dw", 32, 128))),
                         (1024, 64, b8), (1280, 80, b8 + taps), (1920, 120, b8 + taps),
                         (512, 32, b8), (1536, 96, b8), (1792, 112, b8), (2048, 128, b8 + taps),
                         (128, 8, b8), (384, 24, b8), (640, 40, b8), (896, 56, b8), (1152, 72, b8),
                         (1408, 88, b8), (1664, 104, b8)):
        groups = c // cg
        if other_tree and not pc.supports(c, groups, torch.bfloat16, 128):
            print(json.dumps({"label": label, "channels_per_group": cg,
                              "skipped": "the tree's pos_conv.supports does not cover it"}),
                  flush=True)
            continue
        for name, b, k in cases:
            kernel = (torch.randn(k, cg, c, generator=gen) * (1.5 / (k * cg) ** 0.5)).cuda()
            bias = (0.1 * torch.randn(c, generator=gen)).cuda()
            x, dpre = (torch.randn(b, t, c, generator=gen).cuda().to(torch.bfloat16) for _ in range(2))
            fn = {
                "pos_conv": lambda: pc.pos_conv(x, kernel, bias, groups=groups, gelu_approx=True),
                "pos_conv_train_fwd": lambda: pc.pos_conv_train_fwd(x, kernel, bias, groups=groups,
                                                                    gelu_approx=True),
                "pos_conv_dx": lambda: pc.pos_conv_dx(dpre, kernel, groups=groups),
                "pos_conv_dw": lambda: pc.pos_conv_dw(x, dpre, k, groups=groups),
            }[name]
            row = {"label": label, "kernel": name, "shape": [b, t, c], "channels_per_group": cg,
                   "taps": k, "ms": events_ms(torch, fn, 20)}
            row["call_device_ms"], row["device_ms"], row["device_kernel"] = profiled_ms(torch, fn, 5)
            print(json.dumps(row), flush=True)
            del x, dpre
            torch.cuda.empty_cache()


def bench_scatter(torch, label):
    from gsoc_wav2vec2_tpu_torch.models import pretraining
    from gsoc_wav2vec2_tpu_torch.ops.kernels import scatter_add as sa

    gen = torch.Generator().manual_seed(0)
    b, l, k = 8, 768, 100
    lengths = torch.randint(l // 3, l + 1, (b,), generator=gen)
    lengths[0] = l
    mti = (torch.rand(b, l, generator=gen) < 0.65) & (torch.arange(l)[None, :] < lengths[:, None])
    negs = pretraining.sample_negative_indices(gen, mti, k)
    sampler = (negs - (torch.arange(b) * l)[:, None, None].to(torch.int32)).reshape(b, l * k).cuda()
    uniform = torch.randint(0, l, (b, l * k), generator=gen).to(torch.int32).cuda()
    for d in (256, 768):
        for dtype in (torch.float32, torch.bfloat16):
            dneg = torch.randn(b, l * k, d, generator=gen).cuda().to(dtype)
            for kind, idx in (("sampler", sampler), ("uniform", uniform)):
                fn = lambda: sa.scatter_rows_add(dneg, idx, l_rows=l)
                row = {"label": label, "kernel": "scatter_rows_add", "shape": [b, l * k, d],
                       "dtype": str(dtype).replace("torch.", ""), "indices": kind,
                       "sources_on_row_0": (idx == 0).float().mean().item(),
                       "ms": events_ms(torch, fn, 20)}
                rows = profiled_rows(torch, fn, 5)
                row["call_device_ms"] = sum(e.self_device_time_total for e in rows) / 5e3
                row["kernels"] = {e.key[:48]: e.self_device_time_total / 5e3 for e in rows}
                print(json.dumps(row), flush=True)
            del dneg
            torch.cuda.empty_cache()


def bench_ctc(torch, label):
    from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc as ck

    gen = torch.Generator().manual_seed(0)
    for b, t, v in ((32, 768, 32), (16, 768, 32), (1, 5999, 32), (4, 400, 8192)):
        log_probs = torch.log_softmax(2.0 * torch.randn(b, t, v, generator=gen), -1).cuda()
        labels = torch.zeros(b, 200, dtype=torch.int64)
        lengths = torch.full((b,), t, dtype=torch.int64)
        for i in range(b):
            n = int(torch.randint(50, 201, (), generator=gen))
            labels[i, :n] = torch.randint(1, v, (n,), generator=gen)
            if i >= b - b // 4:
                lengths[i] = int(torch.randint(400, t + 1, (), generator=gen))
        labels, lengths = labels.cuda(), lengths.cuda()
        _, states = ck.ctc_loss_fwd(log_probs, labels, lengths)
        ones = torch.ones(b, device="cuda")
        xl = log_probs.clone().requires_grad_(True)
        label_lengths = (labels != 0).sum(1)
        library = lambda: torch.nn.functional.ctc_loss(  # noqa: E731
            xl.transpose(0, 1), labels, lengths, label_lengths, reduction="none",
            zero_infinity=True)
        lib_loss = library().sum()
        fns = {
            "fwd": lambda: ck.ctc_loss_fwd(log_probs, labels, lengths),
            "bwd": lambda: ck.ctc_loss_bwd(log_probs, labels, lengths, states, ones),
            "library_fwd": library,
            "library_bwd": lambda: torch.autograd.grad(lib_loss, xl, retain_graph=True),
        }
        row = {"label": label, "kernel": "ctc", "shape": [b, t, v, 200],
               "frames": int(lengths.max())}
        for name, fn in fns.items():
            row[name + "_ms"] = events_ms(torch, fn, 20)
            rows = profiled_rows(torch, fn, 5)
            row[name + "_device_ms"] = sum(e.self_device_time_total for e in rows) / 5e3
            row[name + "_kernels"] = {e.key[:48]: e.self_device_time_total / 5e3 for e in rows}
        row["fwd_bwd_ms"] = row["fwd_ms"] + row["bwd_ms"]
        row["library_fwd_bwd_ms"] = row["library_fwd_ms"] + row["library_bwd_ms"]
        if hasattr(ck, "chain_step_ms"):
            row["chain_bound_fwd_ms"] = row["frames"] * ck.chain_step_ms(False)
            row["chain_bound_bwd_ms"] = row["frames"] * ck.chain_step_ms(True)
        print(json.dumps(row), flush=True)
        del log_probs, states, xl, lib_loss
        torch.cuda.empty_cache()
    if hasattr(ck, "plan"):  # the instances' registers and spills (-Xptxas -v)
        from gsoc_wav2vec2_tpu_torch.ops.kernels import _build

        report = _build.ptxas_report()
        report = report[report.index("== ctc.cu"):].split("\n== ")[0]
        print(json.dumps({"label": label, "kernel": "ctc", "ptxas": report.splitlines()[1:]}),
              flush=True)


def bench_forward(torch, label):
    import statistics

    from gsoc_wav2vec2_tpu_torch import Wav2Vec2Config, Wav2Vec2ForCTC
    from gsoc_wav2vec2_tpu_torch.models.modeling import wav2vec2_for_ctc_forward

    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    x = torch.randn(16, 246000, generator=torch.Generator().manual_seed(1)).cuda()

    def forward():
        with torch.inference_mode():
            wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    reps = []
    for _ in range(20):
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t) * 1e3)
    rows = profiled_rows(torch, forward, 3)
    print(json.dumps({
        "label": label, "kernel": "base forward", "shape": [16, 246000],
        "ms_per_forward": statistics.median(reps), "ms_min_max": [min(reps), max(reps)],
        "launches_per_forward": sum(e.count for e in rows) / 3,
        "device_busy_ms_per_forward": sum(e.self_device_time_total for e in rows) / 3e3,
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=("flash", "flash_f32", "conv", "pos_conv", "scatter", "ctc", "forward"),
                    default="flash")
    ap.add_argument("--root", default=".", help="checkout to import the package from")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("flash_bench: needs the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    pos_conv = lambda torch, label: bench_pos_conv(torch, label, other_tree=args.root != ".")
    {"flash": bench_flash, "flash_f32": bench_flash_f32, "conv": bench_conv, "pos_conv": pos_conv,
     "scatter": bench_scatter, "ctc": bench_ctc, "forward": bench_forward}[args.family](torch, args.label)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
