"""Times the port's flash-attention kernels against SDPA on one NVIDIA GPU.

    python3 flash_bench.py [--root DIR] [--label NAME]

At each shape of the main paths (base inference, base training, robust,
long), the forward and the backward wrappers of
`gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention`, and
`scaled_dot_product_attention` with the same mask and dropout rate: device
ms a call by CUDA events around 50 back-to-back calls after warm-up (a
device sleep ahead of them keeps the host's wrapper work out), and by
the profiler (the kernels' own time, without the host's wrapper work); and
the wrappers' host time a call at a tiny shape.
`--root` imports the package from another checkout, so that two trees are
compared on one card in one run (parent, change, change, parent).  Prints
one JSON line per shape and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".", help="checkout to import the package from")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bench: needs the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def events_ms(fn, iters=50):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(iters * 1_000_000)  # holds the stream while the host enqueues the run
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def profiled_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        return sum(e.self_device_time_total for e in rows) / 1e3 / reps

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
        row = {"label": args.label, "shape": [b, h, l, 64], "dropout": rate, "ragged_bias": ragged}
        for name, fn in fns.items():
            row[name + "_ms"] = events_ms(fn)
            row[name + "_device_ms"] = profiled_ms(fn)
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, qg, kg, vg, lib_out
        torch.cuda.empty_cache()
    # the wrappers' host time a call, where the device is not the limit
    q, k, v, dout = (torch.randn(1, 1, 64, 64, generator=gen).cuda().to(torch.bfloat16)
                     for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    row = {"label": args.label, "host_us_per_call_at": [1, 1, 64, 64]}
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
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
