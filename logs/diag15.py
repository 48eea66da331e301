"""Phase 15's timing comparison taken apart, on the card: 12 rounds of five
readings of the base forward (the chained host clock, `timeit`, the chain
with `timeit`'s `.sum()`, and `timeit` and the chain with the garbage
collector off), once in a fresh process and once where `chip_smoke.py` runs
phase 15 (after every earlier phase), with each reading's host ms, the
card's event span of its timed calls, GC pauses, main-thread CPU time, steal
and the card's clocks.  Stops after phase 15.

    python3 logs/diag15.py [OUT_DIR]   # from the repo root; OUT_DIR defaults to logs/diag15_out

writes `diag15_fresh.json` / `diag15_late.json` there and prints a summary
line for each."""
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2Config, Wav2Vec2ForCTC  # noqa: E402
from gsoc_wav2vec2_tpu_torch.utils import profiling  # noqa: E402

OUT = sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.getcwd(), "logs", "diag15_out")
os.makedirs(OUT, exist_ok=True)
ROUNDS = 12
REPS = 20
WARM = 3


class Stop(Exception):
    pass


gc_log = []


def _gc_cb(phase, info):
    if phase == "start":
        gc_log.append([info["generation"], time.perf_counter(), None])
    elif gc_log:
        gc_log[-1][2] = time.perf_counter()


gc.callbacks.append(_gc_cb)


def steal():
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:]]
    return v[7], sum(v)


def smi_clocks():
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu,"
                        "clocks_throttle_reasons.active", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return (r.stdout or r.stderr).strip()


def reading(kind, forward):
    """One reading of REPS calls; returns a dict."""
    evs = {}
    calls = [0]
    first = WARM if kind.startswith("timeit") else 0

    def wrapped():
        i = calls[0]
        calls[0] += 1
        if i == first:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs["b"] = e
        out = forward()
        if i == first + REPS - 1:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs["a"] = e
        return out

    nogc = kind.endswith("nogc")
    n_gc = len(gc_log)
    s0 = steal()
    tt0 = time.thread_time()
    pt0 = time.process_time()
    if nogc:
        gc.disable()
    try:
        if kind.startswith("timeit"):
            host = profiling.timeit(wrapped) * 1e3
        elif kind == "chained_sum":
            torch.cuda.synchronize()
            t = time.perf_counter()
            acc = None
            for _ in range(REPS):
                acc = wrapped().sum()
            acc.item()
            host = (time.perf_counter() - t) * 1e3 / REPS
        else:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(REPS):
                wrapped()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t) * 1e3 / REPS
    finally:
        if nogc:
            gc.enable()
    torch.cuda.synchronize()
    s1 = steal()
    pauses = [(g, (b2 - b1) * 1e3) for g, b1, b2 in gc_log[n_gc:] if b2 is not None]
    return {"kind": kind, "host_ms": host, "device_span_ms": evs["b"].elapsed_time(evs["a"]) / REPS,
            "thread_cpu_ms": (time.thread_time() - tt0) * 1e3 / REPS,
            "process_cpu_ms": (time.process_time() - pt0) * 1e3 / REPS,
            "steal_share": (s1[0] - s0[0]) / max(1, s1[1] - s0[1]),
            "gc": [sum(1 for g, _ in pauses if g == k) for k in range(3)],
            "gc_ms": sum(p for _, p in pauses)}


def diag(tag):
    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((cs.B, cs.SAMPLES)).astype(np.float32)).cuda()

    def forward():
        with torch.inference_mode():
            return model(x)

    forward()
    torch.cuda.synchronize()
    kinds = ["chained", "timeit", "chained_sum", "timeit_nogc", "chained_nogc"]
    rounds = []
    t0 = time.perf_counter()
    for r in range(ROUNDS):
        order = kinds[r % len(kinds):] + kinds[: r % len(kinds)]
        rd = {"smi": smi_clocks(), "readings": [reading(k, forward) for k in order]}
        rounds.append(rd)
    phase_s = time.perf_counter() - t0
    n_obj = len(gc.get_objects())
    t = time.perf_counter()
    gc.collect()
    full_gc_ms = (time.perf_counter() - t) * 1e3
    by = {k: [next(x for x in rd["readings"] if x["kind"] == k) for rd in rounds] for k in kinds}
    summary = {}
    for k in kinds:
        summary[k] = {f: [round(x[f], 3) for x in by[k]] for f in ("host_ms", "device_span_ms", "thread_cpu_ms",
                                                                     "steal_share", "gc_ms")}
        summary[k]["gc_counts"] = [x["gc"] for x in by[k]]
    rel = {k: statistics.median(a["host_ms"] / c["host_ms"] - 1 for a, c in zip(by[k], by["chained"]))
           for k in kinds[1:]}
    dev_rel = {k: statistics.median(a["host_ms"] / a["device_span_ms"] - 1 for a in by[k]) for k in kinds}
    res = {"diag": tag, "phase_s": phase_s, "rel_to_chained": rel, "host_over_device_span": dev_rel,
           "gc_objects": n_obj, "full_gc_ms": full_gc_ms, "gc_threshold": gc.get_threshold(),
           "threads": [t.name for t in threading.enumerate()], "os_threads": len(os.listdir("/proc/self/task")),
           "affinity": len(os.sched_getaffinity(0)), "loadavg": os.getloadavg(),
           "smi": [rd["smi"] for rd in rounds], "summary": summary}
    with open(os.path.join(OUT, f"diag15_{tag}.json"), "w") as f:
        json.dump({"rounds": rounds, **res}, f)
    print(json.dumps({k: res[k] for k in ("diag", "phase_s", "rel_to_chained", "host_over_device_span",
                                          "gc_objects", "full_gc_ms", "os_threads", "loadavg")}), flush=True)
    del model, x
    torch.cuda.empty_cache()


def late(smi, main_ms):
    diag("late")
    try:
        profiling_phase(smi, main_ms)  # the phase as it stands, for its own line
    except RuntimeError as e:
        print("phase 15 failed:", str(e)[:300], flush=True)
    raise Stop


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs._build.library()
diag("fresh")
profiling_phase = cs.profiling_phase
cs.profiling_phase = late
sys.argv = sys.argv[:1]
try:
    cs.main()
except Stop:
    print("stopped after phase 15", flush=True)
