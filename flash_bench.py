"""Times the port's hand-written kernels on one NVIDIA GPU.

    python3 flash_bench.py [--family flash|conv|pos_conv] [--root DIR] [--label NAME]

`--family flash` (the default): at each shape of the main paths (base
inference, base training, robust, long), the forward and the backward
wrappers of `gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention`, and
`scaled_dot_product_attention` with the same mask and dropout rate; and the
wrappers' host time a call at a tiny shape.

`--family conv`: the conv front-end kernels of
`gsoc_wav2vec2_tpu_torch.ops.kernels.conv_frontend` at the main paths'
shapes (x 246000 samples): `window_stats` and `conv01` (the base family,
GroupNorm folded into scale/shift) at B=16 (inference) and B=32 (training),
`conv01_robust` at B=8.

`--family pos_conv`: the four wrappers of
`gsoc_wav2vec2_tpu_torch.ops.kernels.pos_conv` at T = 768 frames (246000
samples) and K = 128 taps: base (C = 768, 16 groups) `pos_conv` at B=16 and
`pos_conv_train_fwd`, `pos_conv_dx`, `pos_conv_dw` at B=32; robust/large
(C = 1024, C/G = 64) all four at B=8.

Each time is device ms a call by CUDA events around a back-to-back run after
warm-up (a device sleep ahead of it keeps the host's wrapper work out), and
by the profiler (flash: every kernel of the call; conv, pos_conv: the
call's largest kernel, named, and every kernel of the call).  `--root` imports the package from another checkout, so
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


def profiled_ms(torch, fn, reps):
    """(device ms a call of every kernel, of the largest kernel, its name)
    by the profiler over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    top = max(rows, key=lambda e: e.self_device_time_total)
    return (sum(e.self_device_time_total for e in rows) / 1e3 / reps,
            top.self_device_time_total / 1e3 / reps, top.key[:80])


def bench_flash(torch, label):
    from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(0)
    for b, h, l, rate, ragged in ((16, 12, 768, 0.0, False), (32, 12, 768, 0.1, True),
                                  (8, 16, 768, 0.0, True), (8, 16, 768, 0.1, True),
                                  (1, 12, 5999, 0.1, True)):
        q, k, v, dout = (torch.randn(b, h, l, 64, generator=gen).cuda().to(torch.bfloat16)
                         for _ in range(4))
        q = q * 0.25
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
        row = {"label": label, "shape": [b, h, l, 64], "dropout": rate, "ragged_bias": ragged}
        for name, fn in fns.items():
            row[name + "_ms"] = events_ms(torch, fn, 50)
            row[name + "_device_ms"] = profiled_ms(torch, fn, 10)[0]
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, qg, kg, vg, lib_out
        torch.cuda.empty_cache()
    # the wrappers' host time a call, where the device is not the limit
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


def bench_conv(torch, label):
    from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend as cf

    gen = torch.Generator().manual_seed(0)
    samples, c = 246000, 512
    t0, t1 = cf.conv0_length(samples), cf.conv1_length(samples)
    w0 = (torch.randn(10, 1, c, generator=gen) * 0.3).cuda()
    w1 = (torch.randn(3, c, c, generator=gen) * (1.5 / c ** 0.5)).cuda()
    vec = lambda scale, offset: (offset + scale * torch.randn(c, generator=gen)).cuda()
    gamma, beta = vec(0.1, 1.0), vec(0.1, 0.0)
    robust = (w0, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0), w1, vec(0.1, 0.0), vec(0.1, 1.0),
              vec(0.1, 0.0))
    for name, b in (("window_stats", 16), ("conv01", 16), ("conv01", 32), ("conv01_robust", 8)):
        x = torch.randn(b, samples, generator=gen).cuda().to(torch.bfloat16)
        if name == "window_stats":
            fn = lambda: cf.window_stats(x, t0)
        elif name == "conv01":
            gram, rsum = cf.window_stats_plain(x, t0)
            scale, shift = cf.groupnorm_scale_shift(gram, rsum, w0, gamma, beta, t0, 1e-5)
            fn = lambda: cf.conv01(x, w0, scale, shift, w1, t1, True)
        else:
            fn = lambda: cf.conv01_robust(x, *robust, t1, 1e-5, True)
        row = {"label": label, "kernel": name, "shape": [b, samples], "ms": events_ms(torch, fn, 20)}
        _, row["device_ms"], row["device_kernel"] = profiled_ms(torch, fn, 5)
        print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()


def bench_pos_conv(torch, label):
    from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv as pc

    gen = torch.Generator().manual_seed(0)
    t, k = 768, 128
    for c, cg, cases in ((768, 48, (("pos_conv", 16), ("pos_conv_train_fwd", 32), ("pos_conv_dx", 32),
                                    ("pos_conv_dw", 32))),
                         (1024, 64, (("pos_conv", 8), ("pos_conv_train_fwd", 8), ("pos_conv_dx", 8),
                                     ("pos_conv_dw", 8)))):
        groups = c // cg
        kernel = (torch.randn(k, cg, c, generator=gen) * (1.5 / (k * cg) ** 0.5)).cuda()
        bias = (0.1 * torch.randn(c, generator=gen)).cuda()
        for name, b in cases:
            x, dpre = (torch.randn(b, t, c, generator=gen).cuda().to(torch.bfloat16) for _ in range(2))
            fn = {
                "pos_conv": lambda: pc.pos_conv(x, kernel, bias, groups=groups, gelu_approx=True),
                "pos_conv_train_fwd": lambda: pc.pos_conv_train_fwd(x, kernel, bias, groups=groups,
                                                                    gelu_approx=True),
                "pos_conv_dx": lambda: pc.pos_conv_dx(dpre, kernel, groups=groups),
                "pos_conv_dw": lambda: pc.pos_conv_dw(x, dpre, k, groups=groups),
            }[name]
            row = {"label": label, "kernel": name, "shape": [b, t, c], "channels_per_group": cg,
                   "ms": events_ms(torch, fn, 20)}
            row["call_device_ms"], row["device_ms"], row["device_kernel"] = profiled_ms(torch, fn, 5)
            print(json.dumps(row), flush=True)
            del x, dpre
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=("flash", "conv", "pos_conv"), default="flash")
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
    {"flash": bench_flash, "conv": bench_conv, "pos_conv": bench_pos_conv}[args.family](torch, args.label)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
