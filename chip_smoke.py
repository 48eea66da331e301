"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card    -- device name and `nvidia-smi` name / power limit;
  2. build   -- the CUDA kernels built from `gsoc_wav2vec2_tpu_torch/csrc`;
  3. kernels -- each kernel against its plain PyTorch version at the main
                paths' shapes (inference: B=16 x 246000 samples; training:
                B=32 x 246000, base width), with its median time, the plain
                version's, a PyTorch library call's (a yardstick the port
                never calls) and the card's bound;
  4. main    -- full-width, full-depth base `Wav2Vec2ForCTC` from seeded
                weights: a bf16 batch through `GreedyCTCEvaluator`, three
                requests of different lengths, one 40 s clip through
                `transcribe_long`; launch counts per forward; the card's
                logits against an f32 CPU copy of the model;
  5. profile -- device time by kernel over three forwards;
  6. train   -- the same model with the recipe's regularisation (dropout
                0.1, SpecAugment): one stage-1 step and 12 stage-2 steps of
                `make_train_step` at B=32 x 246000; launch counts per
                stage-2 step, step time, peak memory; then one
                deterministic stage-2 loss + gradient on the card (bf16)
                against the same card step through the plain attention
                backward and against the f32 CPU copy.
Then the `kernels` line (every kernel's record), the card line and, last,
{"ok": true, "device": {...}}.  Any failure raises and the script exits
non-zero without that line; without CUDA it exits at once.
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
from gsoc_wav2vec2_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_ctc_loss_fn,
    make_train_step,
    set_trainable,
)

# Published H100 SXM peaks (dense): bf16 tensor cores, HBM3.
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

B, SAMPLES = 16, 246000
TRAIN_B = 32  # the recipe's per-device batch (cli/train.py)
STAGE2 = ("feature_extractor",)
STAGE1 = ("wav2vec2",)
STAGE2_STEPS = 12


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


def profile_device(fn, reps: int, unit: str, top: int = 15):
    """Device time by kernel over `reps` calls of `fn` (torch.profiler,
    CUPTI), and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    # device-side events only (the CPU ops' entries repeat their kernels' time)
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {
        f"wall_ms_per_{unit}": wall_ms, f"device_busy_ms_per_{unit}": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:top]],
    }


def profile_forward(model, config, x, reps: int = 3):
    """Device time by kernel over `reps` bf16 forwards."""
    def forward():
        with torch.inference_mode():
            wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)

    return profile_device(forward, reps, "forward")


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


def _ragged_bias(b: int, l: int, gen: torch.Generator) -> torch.Tensor:
    lengths = torch.randint(l // 4, l + 1, (b,), generator=gen)
    return torch.where(torch.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).cuda()


def check_train_kernels(model, records):
    """Phase 3, training shapes (B=32 x 246000: L = T = 768, base width):
    flash forward with dropout (into the forward's record), flash backward,
    and the positional conv's training forward, dx and dW.  Appends records."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    heads = model.config.num_heads
    h = model.config.hidden_size
    d = h // heads
    t = model.config.conv_output_length(SAMPLES)  # 768
    rate, seed = 0.1, 12345
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # -- flash forward with dropout 0.1; ragged bias; L = 768 and 1249 --------
    fwd = next(r for r in records if r["name"] == "flash_attention_fwd")
    bwd_errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    fwd_err, bwd_abs, bwd_mean = (0.0, 0.0), 0.0, 0.0
    for b, l in ((8, 1249), (TRAIN_B, t)):
        q, kk, v, dout = (torch.randn(b, heads, l, d, generator=gen).to(dev, torch.bfloat16)
                          for _ in range(4))
        q = q * (2.0 * d ** -0.5)  # scores with std ~2 after the D^-1/2 prescale
        kb = _ragged_bias(b, l, gen)
        out, lse = fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=seed)
        pout, plse = fa.flash_attention_fwd_plain(q, kk, v, kb, dropout_rate=rate, seed=seed)
        torch.cuda.synchronize()
        err, mean_err = errors(out, pout)
        lse_err, _ = errors(lse, plse)
        # bf16 output (|out| < 4: ulp 2^-6): p rounded before / after the
        # normalisation and the 1 / (1 - rate) scaling: 2.5 ulp; a mask that
        # differed in one element of a row would move that row by ~|v| p / 0.9
        tol = 0.04
        require(err <= tol and mean_err <= 2e-3 and lse_err <= 1e-3,
                f"flash dropout L={l}: {err} / mean {mean_err} / lse {lse_err}")
        fwd_err = max(fwd_err, (err, mean_err))
        # -- the backward, same inputs ------------------------------------------
        grads = fa.flash_attention_bwd(q, kk, v, kb, pout, plse, dout, dropout_rate=rate, seed=seed)
        pgrads = fa.flash_attention_bwd_plain(q, kk, v, kb, pout, plse, dout,
                                              dropout_rate=rate, seed=seed)
        torch.cuda.synchronize()
        for name, g, pg in zip(("dq", "dk", "dv"), grads, pgrads):
            err, mean_err = errors(g, pg)
            scale = pg.float().abs().max().item()
            # bf16 outputs of f32 sums over L in another order: 1% of the
            # tensor's scale (~1.3 ulp at its top), mean 0.1%
            require(err <= 0.01 * scale and mean_err <= 1e-3 * scale,
                    f"flash bwd {name} L={l}: {err} / mean {mean_err} (scale {scale})")
            bwd_errs[name] = max(bwd_errs[name], err / scale)
            bwd_abs, bwd_mean = max(bwd_abs, err), max(bwd_mean, mean_err)
        del grads, pgrads, pout
    n_qkv = q.numel()
    mask4 = kb[:, None, None, :].to(q.dtype)  # SDPA's additive mask
    nbytes = 4 * n_qkv * 2 + TRAIN_B * heads * t * 4 + TRAIN_B * t * 4
    bms, by = bound(nbytes, 4 * TRAIN_B * heads * t * t * d, PEAK_BF16)
    fwd["train"] = dict(
        shape=[TRAIN_B, heads, t, d], dropout=rate, ragged_bias=True,
        max_abs_err=fwd_err[0], mean_abs_err=fwd_err[1], tol=0.04,
        ms=time_ms(lambda: fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=seed), 20),
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
            q, kk, v, kb, dropout_rate=rate, seed=seed), 3, 1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(q, kk, v, attn_mask=mask4, dropout_p=rate, scale=1.0), 20),
    )
    # backward: q, k, v, out, dout, lse, bias in; dq, dk, dv out; the five
    # products S, dP, dV, dK, dQ of 2 B H L^2 D each
    nbytes = 8 * n_qkv * 2 + TRAIN_B * heads * t * 4 + TRAIN_B * t * 4
    bms, by = bound(nbytes, 5 * 2 * TRAIN_B * heads * t * t * d, PEAK_BF16)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, kk, v))
    lib_out = sdpa(qg, kg, vg, attn_mask=mask4, dropout_p=rate, scale=1.0)
    records.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="gsoc_wav2vec2_tpu_torch/csrc/flash_attention.cu",
        replaces="gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py:285",
        shape=[TRAIN_B, heads, t, d], dropout=rate, ragged_bias=True,
        max_abs_err=bwd_abs, mean_abs_err=bwd_mean, max_rel_err_by_grad=bwd_errs,
        tol="0.01 x each gradient's max |value|",
        ms=time_ms(lambda: fa.flash_attention_bwd(q, kk, v, kb, out, lse, dout,
                                                  dropout_rate=rate, seed=seed), 20),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
            q, kk, v, kb, out, lse, dout, dropout_rate=rate, seed=seed), 3, 1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout,
                                                       retain_graph=True), 20),
    ))
    del q, kk, v, dout, out, lse, qg, kg, vg, lib_out, mask4
    torch.cuda.empty_cache()

    # -- positional conv: training forward, dx (also at T = 3000), dW --------
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    k, cg, _ = kernel.shape
    groups = h // cg
    bias = (0.1 * torch.randn(h, generator=gen)).to(dev)
    for tt in (3000, t):
        bb = TRAIN_B if tt == t else 2
        x, dpre = (torch.randn(bb, tt, h, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
        y, pre = pc.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True)
        py, ppre = pc.pos_conv_train_fwd_plain(x, kernel, bias, groups=groups, gelu_approx=True)
        dx = pc.pos_conv_dx(dpre, kernel, groups=groups)
        pdx = pc.pos_conv_dx_plain(dpre, kernel, groups=groups)
        dw = pc.pos_conv_dw(x, dpre, k, groups=groups)
        pdw = pc.pos_conv_dw_plain(x, dpre, k, groups=groups)
        torch.cuda.synchronize()
        checks = {"pos_conv_train_fwd": errors(y, py), "pre": errors(pre, ppre),
                  "pos_conv_dx": errors(dx, pdx), "pos_conv_dw": errors(dw, pdw)}
        # bf16 outputs: as pos_conv (0.05, mean 5e-3); dx 1.5% of its scale
        # (2 ulp at its top); f32 outputs (pre-activation, dW: sums of
        # K*CG = 6144 and B*T products in another order): 1e-4 of the scale
        scales = {"pre": ppre.abs().max().item(), "pos_conv_dx": pdx.float().abs().max().item(),
                  "pos_conv_dw": pdw.abs().max().item()}
        tols = {"pos_conv_train_fwd": 0.05, "pre": 1e-4 * scales["pre"],
                "pos_conv_dx": 0.015 * scales["pos_conv_dx"], "pos_conv_dw": 1e-4 * scales["pos_conv_dw"]}
        for name, (err, mean_err) in checks.items():
            require(err <= tols[name], f"{name} T={tt}: err {err} > {tols[name]}")
        require(checks["pos_conv_train_fwd"][1] <= 5e-3, "pos_conv_train_fwd: mean error")
        del y, py, pre, ppre, dx, pdx, dw, pdw
    flops = 2 * TRAIN_B * t * k * cg * h
    act = x.numel() * 2  # one (B, T, C) bf16 tensor
    wt = kernel.to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, CG, K)
    bb16 = bias.to(torch.bfloat16)
    xt, dt = x.transpose(1, 2).contiguous(), dpre.transpose(1, 2).contiguous()
    # the conv's own (B, C, T + 1) output gradient: the cropped frame gets 0
    dy = torch.nn.functional.pad(dt, (0, 1))
    conv_bwd = torch.ops.aten.convolution_backward

    def library_fwd():
        y = torch.nn.functional.conv1d(xt, wt, bb16, padding=k // 2, groups=groups)
        return torch.nn.functional.gelu(y[:, :, :t], approximate="tanh")

    def library_grad(mask):
        return conv_bwd(dy, xt, wt, None, [1], [k // 2], [1], False, [0], groups, mask)

    # dx as one forward grouped conv of dpre with the flipped, swapped kernel:
    # pad (K/2 - 1, K/2) is the symmetric K/2 with the first output dropped
    wdx = pc.dx_kernel(kernel, groups).to(torch.bfloat16).permute(2, 1, 0).contiguous()

    def library_dx():
        return torch.nn.functional.conv1d(dt, wdx, padding=k // 2, groups=groups)[:, :, 1:]

    lib_err = errors(library_dx().transpose(1, 2), pc.pos_conv_dx_plain(dpre, kernel, groups=groups))[0]
    require(lib_err <= 0.015 * scales["pos_conv_dx"], f"the dx yardstick computes another function: {lib_err}")

    specs = [
        ("pos_conv_train_fwd", "gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py:324",
         act + kernel.numel() * 2 + h * 4 + act + 2 * act,  # x, W, b in; y bf16 + pre f32 out
         lambda: pc.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True),
         lambda: pc.pos_conv_train_fwd_plain(x, kernel, bias, groups=groups, gelu_approx=True),
         library_fwd, checks["pos_conv_train_fwd"]),
        ("pos_conv_dx", "gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py:372",
         act + kernel.numel() * 2 + act,  # dpre, W in; dx out
         lambda: pc.pos_conv_dx(dpre, kernel, groups=groups),
         lambda: pc.pos_conv_dx_plain(dpre, kernel, groups=groups),
         library_dx, checks["pos_conv_dx"]),
        ("pos_conv_dw", "gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py:402",
         2 * act + kernel.numel() * 4,  # x, dpre in; dW f32 out
         lambda: pc.pos_conv_dw(x, dpre, k, groups=groups),
         lambda: pc.pos_conv_dw_plain(x, dpre, k, groups=groups),
         lambda: library_grad([False, True, False]), checks["pos_conv_dw"]),
    ]
    for name, replaces, nbytes, kern_fn, plain_fn, lib_fn, (err, mean_err) in specs:
        bms, by = bound(nbytes, flops, PEAK_BF16)
        records.append(dict(
            name=name, route="cuda", source="gsoc_wav2vec2_tpu_torch/csrc/pos_conv.cu",
            replaces=replaces, shape=[TRAIN_B, t, h],
            max_abs_err=err, mean_abs_err=mean_err, tol=tols[name],
            ms=time_ms(kern_fn, 20), plain_ms=time_ms(plain_fn, 3, 1),
            bound_ms=bms, bound_by=by, library_ms=time_ms(lib_fn, 20),
        ))
    # the input gradient through convolution_backward (what autograd calls on
    # the conv): cuDNN takes another, much slower route; kept for the record
    records[-2]["library_conv_backward_ms"] = time_ms(lambda: library_grad([True, False, False]), 3, 1)
    del x, dpre, xt, dt, dy, wdx
    torch.cuda.empty_cache()


def _labels(rng, b: int, vocab: int) -> np.ndarray:
    """50-200 non-pad ids per sample from the vocabulary, pad (0) after."""
    lengths = rng.integers(50, 201, size=b)
    labels = np.zeros((b, 200), np.int64)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, vocab, size=n)
    return labels


def train_phase(kernels, smi: str):
    """Phase 6.  Returns the launch counts of the counted run (one stage-1
    step and the stage-2 steps)."""
    dev = torch.device("cuda")
    config = Wav2Vec2Config()  # base, the recipe's dropout 0.1 and SpecAugment
    require(config.dropout == 0.1 and config.apply_spec_augment, "the recipe's regularisation")
    model = Wav2Vec2ForCTC(config, device=dev, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"speech": rng.standard_normal((TRAIN_B, SAMPLES)).astype(np.float32),
             "labels": _labels(rng, TRAIN_B, config.vocab_size)}
    gen = torch.Generator().manual_seed(0)
    per_step = {"window_stats": 1, "fused_conv01": 1, "pos_conv": 0,
                "pos_conv_train_fwd": 1, "pos_conv_dx": 1, "pos_conv_dw": 1,
                "flash_attention_fwd": config.num_layers, "flash_attention_bwd": config.num_layers}

    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    # stage 1: the backbone frozen, Adam 1e-3 on the head
    set_trainable(model, STAGE1)
    st = create_train_state(model, create_optimizer(model, 1e-3))
    step1 = make_train_step(config, division_factor=TRAIN_B)
    st, m1 = step1(st, batch, gen)
    loss1 = m1["loss"].item()
    # stage 2: all but the conv front end, Adam 1e-4
    mask = set_trainable(model, STAGE2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    st = create_train_state(model, create_optimizer(model, 1e-4))
    step2 = make_train_step(config, division_factor=TRAIN_B)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    for i in range(STAGE2_STEPS):
        counts = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step2(st, batch, gen)
        losses.append(m["loss"].item())  # reads back: the step is done
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        norms.append(m["grad_norm"].item())
        got = {k: fn.launches - counts[k] for k, fn in kernels.items()}
        require(got == per_step, f"launches in stage-2 step {i}: {got} != {per_step}")
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(all(np.isfinite(losses + norms)) and np.isfinite(loss1), f"losses {loss1} {losses}")
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        require(same != mask[name], f"{name}: trainable {mask[name]}, unchanged {same}")
    steady = times[2:]
    step_ms = statistics.median(steady)
    audio_s = TRAIN_B * SAMPLES / 16000
    emit({"phase": "train", "config": "base (768-d, 12 layers) dropout 0.1, SpecAugment, seed 0",
          "batch": [TRAIN_B, SAMPLES], "stage1_loss": loss1, "stage2_losses": losses,
          "stage2_grad_norms": norms, "launches_per_stage2_step": per_step,
          "ms_per_stage2_step": step_ms, "ms_min_max": [min(steady), max(steady)],
          "steps_timed": len(steady), "first_steps_ms": times[:2],
          "audio_s_trained_per_s": audio_s / (step_ms / 1e3), "peak_memory_gb": peak_gb,
          "card": smi})
    # one more stage-2 step under the profiler (after the counted run)
    emit({"phase": "train_profile",
          **profile_device(lambda: step2(st, batch, gen), 1, "stage2_step", top=25)})
    del st, model, before
    torch.cuda.empty_cache()
    card_vs_cpu(config)
    return launches


def card_vs_cpu(base_config):
    """One deterministic stage-2 loss + gradient (dropout 0, SpecAugment
    off) on the card in bf16 and on the f32 CPU copy, B=1 x 246000."""
    config = Wav2Vec2Config(**{**base_config.__dict__, "dropout": 0.0, "apply_spec_augment": False})
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    batch = {"speech": rng.standard_normal((1, SAMPLES)).astype(np.float32),
             "labels": _labels(rng, 1, config.vocab_size)}
    mask = set_trainable(model, STAGE2)
    loss_fn = make_ctc_loss_fn(config, division_factor=1)

    def grads():
        out = {n: p.grad.detach().float().cpu().flatten()
               for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    def forward():
        model.zero_grad(set_to_none=True)
        return loss_fn(model, batch, torch.Generator().manual_seed(0))

    loss = forward()
    loss.backward(retain_graph=True)
    card_loss, card_grads = loss.item(), grads()
    # the same graph (one forward) back through the plain attention backward
    # (bf16, JAX's roundings): what isolates the kernel backward.  A second
    # forward would not do: the card's forward is not bit-reproducible
    # (window_stats sums with f32 atomics), and through 12 random-weight
    # layers its loss moves by up to ~0.5% between two forwards
    kernel_bwd = fa.flash_attention_bwd
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        loss.backward()
    finally:
        fa.flash_attention_bwd = kernel_bwd
    plain_grads = grads()
    del loss
    with torch.no_grad():
        second_loss = forward().item()
    model.to("cpu")
    loss = forward()
    loss.backward()
    cpu_loss, cpu_grads = loss.item(), grads()
    require(card_grads.keys() == cpu_grads.keys() == plain_grads.keys() and
            all(mask[n] for n in cpu_grads), "the card and the CPU differ in which leaves get grads")

    def cosine(a, c):  # in f64: f32 sums over 94 M elements drift past 1
        a, c = a.double(), c.double()
        return (a @ c / (a.norm() * c.norm())).item()

    def rel_err(a, c):  # ||a - c|| / ||c||: sees a scale error, which a cosine does not
        a, c = a.double(), c.double()
        return ((a - c).norm() / c.norm()).item()

    names = list(cpu_grads)
    cos = cosine(torch.cat([card_grads[n] for n in names]), torch.cat([cpu_grads[n] for n in names]))
    per = {n: cosine(card_grads[n], cpu_grads[n]) for n in names}
    worst = min(per, key=per.get)
    # kernel against plain backward, per tensor; the key biases' gradient is
    # 0 in exact arithmetic (softmax ignores a per-row constant): noise only
    held = [n for n in names if not n.endswith("k_proj.bias")]
    vs_plain = {n: cosine(card_grads[n], plain_grads[n]) for n in held}
    rel_plain = {n: rel_err(card_grads[n], plain_grads[n]) for n in held}
    worst_plain = min(vs_plain, key=vs_plain.get)
    worst_rel = max(rel_plain, key=rel_plain.get)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    emit({"phase": "train_card_vs_cpu", "batch": [1, SAMPLES], "card_bf16_loss": card_loss,
          "card_bf16_loss_second_forward": second_loss, "cpu_f32_loss": cpu_loss,
          "loss_rel_diff": rel,
          "grad_cosine": cos, "min_tensor_cosine": per[worst], "min_tensor": worst,
          "kernel_vs_plain_bwd_min_cosine": vs_plain[worst_plain], "its_tensor": worst_plain,
          "kernel_vs_plain_bwd_max_rel_err": rel_plain[worst_rel], "its_rel_tensor": worst_rel})
    # the kernel backward against the plain one through the same graph: f32
    # sums in another order and bf16 roundings of ds that flip (measured:
    # lowest per-tensor cosine 0.999996, a layer-6 k projection)
    require(vs_plain[worst_plain] >= 0.9999 and rel_plain[worst_rel] <= 0.01,
            f"kernel vs plain attention backward: {worst_plain} cosine {vs_plain[worst_plain]}, "
            f"{worst_rel} rel err {rel_plain[worst_rel]}")
    # bf16 through 12 layers and back against f32.  Measured: the card's
    # loss 0.0006-0.21% off the f32 one, a second card forward up to 0.54%
    # off the first; flattened cosine 0.99991-0.99992
    require(rel <= 0.015 and cos >= 0.999, f"card vs CPU: loss rel {rel}, grad cosine {cos}")


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
    check_train_kernels(model, records)
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
    by_path = {"inference": launches}

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

    # 6. training
    train_kernels = {**kernels, "pos_conv_train_fwd": pc.pos_conv_train_fwd,
                     "pos_conv_dx": pc.pos_conv_dx, "pos_conv_dw": pc.pos_conv_dw,
                     "flash_attention_bwd": fa.flash_attention_bwd}
    by_path["train"] = train_phase(train_kernels, smi)
    for r in records:
        r["launches_by_path"] = {p: c.get(r["name"], 0) for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        require(r["launches"] > 0, f"{r['name']} never launched on a main path")

    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
