"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card    -- device name and `nvidia-smi` name / power limit;
  2. build   -- the CUDA kernels built from `gsoc_wav2vec2_tpu_torch/csrc`;
  3. kernels -- each kernel against its plain PyTorch version at the main
                path's shapes (B=16 x 246000 samples, base width), with its
                median time, the plain version's, a PyTorch library call's
                (a yardstick the port never calls) and the card's bound;
  4. main    -- full-width, full-depth base `Wav2Vec2ForCTC` from seeded
                weights: a bf16 batch through `GreedyCTCEvaluator`, three
                requests of different lengths, one 40 s clip through
                `transcribe_long`; launch counts per forward; the card's
                logits against an f32 CPU copy of the model.
The last line is {"ok": true, "device": {...}}.  Any failure raises and the
script exits non-zero without that line; without CUDA it exits at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gsoc_wav2vec2_tpu_torch import GreedyCTCEvaluator, Wav2Vec2Config, Wav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.evaluation import plan_chunks
from gsoc_wav2vec2_tpu_torch.models.modeling import wav2vec2_for_ctc_forward
from gsoc_wav2vec2_tpu_torch.ops import conv as conv_ops
from gsoc_wav2vec2_tpu_torch.ops.kernels import _build
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend as cf
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa
from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv as pc

# Published H100 SXM peaks (dense): bf16 tensor cores, HBM3.
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

B, SAMPLES = 16, 246000


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(got: torch.Tensor, want: torch.Tensor):
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item()


def profile_forward(model, config, x, reps: int = 3):
    """Device time by kernel over `reps` bf16 forwards (torch.profiler,
    CUPTI), and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    # device-side events only (the CPU ops' entries repeat their kernels' time)
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {
        "wall_ms_per_forward": wall_ms, "device_busy_ms_per_forward": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:15]],
    }


def check_kernels(model):
    """Phase 3.  Returns the kernel records (launches filled in later)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    fe = model.wav2vec2.feature_extractor.conv_layers
    w0, w1 = fe[0].conv.kernel, fe[1].conv.kernel
    gamma, beta = fe[0].layer_norm.gamma, fe[0].layer_norm.beta
    c = w0.shape[-1]
    records = []

    # -- window_stats + fused_conv01 at (16, 246000) --------------------------
    x = torch.randn(B, SAMPLES, generator=gen).to(dev, torch.bfloat16)
    t0 = cf.conv0_length(SAMPLES)
    t1 = 1 + (t0 - 3) // 2
    gram, rsum = cf.window_stats(x, t0)
    pgram, prsum = cf.window_stats_plain(x, t0)
    torch.cuda.synchronize()
    # f32 sums in another order (atomics): 1e-5 of each matrix's scale
    tol = 1e-5 * max(pgram.abs().max().item(), prsum.abs().max().item())
    err, mean_err = max(errors(gram, pgram), errors(rsum, prsum))
    require(err <= tol, f"window_stats: max abs err {err} > {tol}")
    nbytes = x.numel() * 2 + B * 110 * 4
    # what the function needs per window: the 55 distinct Gram products (the
    # matrix is symmetric) and 10 sums; bf16 operands, f32 accumulation
    flops = B * t0 * (2 * 55 + 10)
    bms, by = bound(nbytes, flops, PEAK_BF16)
    records.append(dict(
        name="window_stats", route="cuda", source="gsoc_wav2vec2_tpu_torch/csrc/conv_frontend.cu",
        replaces="gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py:87",
        max_abs_err=err, mean_abs_err=mean_err, tol=tol,
        ms=time_ms(lambda: cf.window_stats(x, t0), 20),
        plain_ms=time_ms(lambda: cf.window_stats_plain(x, t0), 5),
        bound_ms=bms, bound_by=by, library_ms=None,
    ))

    scale, shift = cf.groupnorm_scale_shift(pgram, prsum, w0, gamma, beta, t0, 1e-5)
    got = cf.conv01(x, w0, scale, shift, w1, t1, True)
    want = cf.conv01_plain(x, w0, scale, shift, w1, t1, True)
    torch.cuda.synchronize()
    require(got.shape == (B, t1, c), f"conv01 shape {tuple(got.shape)}")
    err, mean_err = errors(got, want)
    del want
    tol = 0.05  # bf16 output (ulp 2^-6 at |y| in [2, 4)) over f32 sums in another order
    require(err <= tol and mean_err <= 5e-3, f"fused_conv01: err {err} / mean {mean_err}")
    nbytes = x.numel() * 2 + (10 * c + 3 * c * c) * 2 + 2 * B * c * 4 + B * t1 * c * 2
    flops = 2 * B * t1 * (2 * 10 * c + 3 * c * c)
    bms, by = bound(nbytes, flops, PEAK_BF16)
    w0t = w0.to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, 1, 10)
    w1t = w1.to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, C, 3)
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

    def library_conv01():
        y = torch.nn.functional.conv1d(x[:, None, :], w0t, stride=5)
        y = torch.nn.functional.gelu(torch.nn.functional.group_norm(y, c, gb, bb), approximate="tanh")
        y = torch.nn.functional.conv1d(y, w1t, stride=2)
        return torch.nn.functional.gelu(y, approximate="tanh")

    records.append(dict(
        name="fused_conv01", route="cuda", source="gsoc_wav2vec2_tpu_torch/csrc/conv_frontend.cu",
        replaces="gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py:251",
        max_abs_err=err, mean_abs_err=mean_err, tol=tol,
        ms=time_ms(lambda: cf.conv01(x, w0, scale, shift, w1, t1, True), 10),
        plain_ms=time_ms(lambda: cf.conv01_plain(x, w0, scale, shift, w1, t1, True), 3, 1),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library_conv01, 10),
    ))
    del x, got

    # -- pos_conv at (16, 768, 768), also checked at T = 3000 -----------------
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    k, cg, h = kernel.shape
    groups = h // cg
    bias = (0.1 * torch.randn(h, generator=gen)).to(dev)
    t = model.config.conv_output_length(SAMPLES)  # 768 frames
    for tt in (3000, t):
        xs = torch.randn(B if tt == t else 2, tt, h, generator=gen).to(dev, torch.bfloat16)
        got = pc.pos_conv(xs, kernel, bias, groups=groups, gelu_approx=True)
        want = pc.pos_conv_plain(xs, kernel, bias, groups=groups, gelu_approx=True)
        torch.cuda.synchronize()
        err, mean_err = errors(got, want)
        tol = 0.05
        require(err <= tol and mean_err <= 5e-3, f"pos_conv T={tt}: err {err} / mean {mean_err}")
    nbytes = xs.numel() * 2 * 2 + kernel.numel() * 2 + h * 4
    flops = 2 * B * t * k * cg * h
    bms, by = bound(nbytes, flops, PEAK_BF16)
    wt = kernel.to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, CG, K)
    bb = bias.to(torch.bfloat16)

    def library_pos_conv():
        y = torch.nn.functional.conv1d(xs.transpose(1, 2), wt, bb, padding=k // 2, groups=groups)
        return torch.nn.functional.gelu(y[:, :, :t], approximate="tanh")

    records.append(dict(
        name="pos_conv", route="cuda", source="gsoc_wav2vec2_tpu_torch/csrc/pos_conv.cu",
        replaces="gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py:250",
        max_abs_err=err, mean_abs_err=mean_err, tol=tol,
        ms=time_ms(lambda: pc.pos_conv(xs, kernel, bias, groups=groups, gelu_approx=True), 20),
        plain_ms=time_ms(lambda: pc.pos_conv_plain(xs, kernel, bias, groups=groups, gelu_approx=True), 5),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library_pos_conv, 20),
    ))

    # -- flash attention at (16, 12, 768, 64); ragged masks and L = 1249 -------
    heads = model.config.num_heads
    d = h // heads
    checks = []
    for l, ragged in ((1249, True), (t, True), (t, False)):
        q, kk, v = (torch.randn(B, heads, l, d, generator=gen).to(dev, torch.bfloat16)
                    for _ in range(3))
        q = q * (2.0 * d ** -0.5)  # scores with std ~2 after the D^-1/2 prescale
        kb = None
        if ragged:
            lengths = torch.randint(l // 4, l + 1, (B,), generator=gen)
            kb = torch.where(torch.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).to(dev)
        out, lse = fa.flash_attention_fwd(q, kk, v, kb)
        pout, plse = fa.flash_attention_fwd_plain(q, kk, v, kb)
        torch.cuda.synchronize()
        err, mean_err = errors(out, pout)
        lse_err, _ = errors(lse, plse)
        tol = 0.02  # bf16 output; p rounded to bf16 before / after the 1/l scaling
        require(err <= tol and lse_err <= 1e-3, f"flash L={l} ragged={ragged}: {err} / lse {lse_err}")
        checks.append(err)
    nbytes = 4 * q.numel() * 2 + B * heads * t * 4
    flops = 4 * B * heads * t * t * d
    bms, by = bound(nbytes, flops, PEAK_BF16)
    records.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="gsoc_wav2vec2_tpu_torch/csrc/flash_attention.cu",
        replaces="gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py:224",
        max_abs_err=max(checks), mean_abs_err=mean_err, tol=tol,
        ms=time_ms(lambda: fa.flash_attention_fwd(q, kk, v), 20),
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(q, kk, v), 5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, scale=1.0), 20),
    ))
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "card", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t_build = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t_build})

    # the model of phase 4 (its weights also feed phase 3)
    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)  # base: 768-d, 12 layers
    model = Wav2Vec2ForCTC(config, device=dev, generator=torch.Generator().manual_seed(0))

    # 3. kernels
    records = check_kernels(model)
    emit({"phase": "kernels", "checked": [r["name"] for r in records]})

    # 4. main path
    kernels = {"window_stats": cf.window_stats, "fused_conv01": cf.conv01,
               "pos_conv": pc.pos_conv, "flash_attention_fwd": fa.flash_attention_fwd}
    per_forward = {"window_stats": 1, "fused_conv01": 1, "pos_conv": 1,
                   "flash_attention_fwd": config.num_layers}
    evaluator = GreedyCTCEvaluator(model)
    require(evaluator.compute_dtype == torch.bfloat16, "the card path must run in bf16")
    rng = np.random.default_rng(0)
    speech = rng.standard_normal((B, SAMPLES)).astype(np.float32)
    utterances = [rng.standard_normal(n).astype(np.float32) for n in (SAMPLES, 160000, 83000)]
    clip = rng.standard_normal(40 * 16000).astype(np.float32)

    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t_main = time.perf_counter()
    texts = evaluator.predict_batch(speech)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t_main
    first = {k: fn.launches for k, fn in kernels.items()}
    padded = np.zeros((3, SAMPLES), np.float32)
    for i, u in enumerate(utterances):
        padded[i, : len(u)] = u
    t_req = time.perf_counter()
    answers = evaluator.predict_batch(padded, np.array([len(u) for u in utterances]))
    req_s = time.perf_counter() - t_req
    t_long = time.perf_counter()
    long_text = evaluator.transcribe_long(clip)
    long_s = time.perf_counter() - t_long
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    require(first == per_forward, f"launches in one forward {first} != {per_forward}")
    n_chunks = len(plan_chunks(len(clip), 246000, 16000, config.conv_output_length, 320))
    forwards = 2 + n_chunks
    want = {k: v * forwards for k, v in per_forward.items()}
    require(launches == want, f"launches over the main path {launches} != {want}")
    require(len(texts) == B and len(answers) == 3 and isinstance(long_text, str),
            "the evaluator returned the wrong number of transcripts")
    for r in records:
        r["launches"] = launches[r["name"]]

    # steady-state forward time of the B=16 batch (device-synchronised host clock)
    x = torch.from_numpy(speech).to(dev)
    with torch.inference_mode():
        logits = wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(logits).all()), "non-finite logits on the card")
        require(logits.shape == (B, config.conv_output_length(SAMPLES), config.vocab_size),
                f"logits shape {tuple(logits.shape)}")
        reps = []
        for _ in range(20):
            t = time.perf_counter()
            wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t)
    fwd_ms = statistics.median(reps) * 1e3
    row0 = logits[0].float().cpu()
    profile = profile_forward(model, config, x)
    del x, logits

    # the card's bf16 logits against the model's f32 CPU path, row 0
    cpu_model = model.to("cpu")
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(
            cpu_model, config, torch.from_numpy(speech[:1]), compute_dtype=torch.float32)[0]
    diff = (row0 - ref).abs()
    scale = ref.abs().max().item()
    agree = (row0.argmax(-1) == ref.argmax(-1)).float().mean().item()
    # bf16 through 12 layers against f32: 5% of the logit scale, and the
    # greedy path (argmax per frame) on >= 90% of frames
    require(diff.max().item() <= 0.05 * scale and agree >= 0.9,
             f"card bf16 vs CPU f32: max {diff.max().item()} (scale {scale}), argmax agree {agree}")
    audio_s = B * SAMPLES / 16000
    emit({"phase": "main", "config": "base (768-d, 12 layers, 12 heads) random seed 0",
          "batch": [B, SAMPLES], "launches_per_forward": first, "forwards": forwards,
          "ms_per_forward": fwd_ms, "ms_per_forward_min_max": [min(reps) * 1e3, max(reps) * 1e3],
          "forward_reps": len(reps), "audio_s_per_s": audio_s / (fwd_ms / 1e3),
          "predict_batch_s": batch_s, "requests_s": req_s, "transcribe_long_s": long_s,
          "long_chunks": n_chunks, "cpu_f32_max_abs_err": diff.max().item(),
          "cpu_f32_mean_abs_err": diff.mean().item(), "logit_scale": scale,
          "argmax_agree": agree, "card": smi})
    emit({"phase": "profile", **profile})

    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
