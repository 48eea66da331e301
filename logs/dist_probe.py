"""Two ranks on one card: what NCCL and gloo do there (a probe for the chip).

    python logs/dist_probe.py            # the parent: starts the ranks
    (python logs/dist_probe.py rank <mode>  is what each rank runs)

The parent first runs a CUDA kernel and holds then frees 4 GB, then starts
two fresh interpreters on cuda:0 for each mode (nccl, gloo) with RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=127.0.0.1 and a MASTER_PORT from a
freshly bound socket, and prints one JSON line of what they report.
"""
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import torch

MB19 = (16, 768, 768)  # one row-parallel activation at B=16, bf16: 18.9 MB


def _timed(fn, reps=10, warmup=2):
    import torch.distributed as dist
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    out.sort()
    return {"median_ms": out[len(out) // 2], "min_ms": out[0], "max_ms": out[-1]}


def rank_main(mode: str) -> None:
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    out = {"rank": rank, "mode": mode, "mem_get_info_gb": [v / 1e9 for v in torch.cuda.mem_get_info()]}
    t = time.perf_counter()
    if mode == "nccl":
        try:
            dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world,
                                    timeout=timedelta(seconds=60))
            out["init_s"] = time.perf_counter() - t
            x = torch.full((4,), float(rank + 1), device="cuda")
            dist.all_reduce(x)
            torch.cuda.synchronize()
            out["all_reduce"] = x.tolist()
        except Exception as e:  # the probe's point: record what NCCL says
            out["error"] = f"{type(e).__name__}: {e}"[-3000:]
        print(json.dumps(out), flush=True)
        os._exit(0)
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    out["init_s"] = time.perf_counter() - t
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        for op in ("all_reduce", "broadcast", "all_gather"):
            key = f"{op}_{str(dtype).split('.')[-1]}"
            try:
                x = torch.full((1000,), float(rank + 1), dtype=dtype, device="cuda")
                if op == "all_reduce":
                    dist.all_reduce(x)
                    ok = bool((x.float() == 3).all()) and x.is_cuda
                elif op == "broadcast":
                    dist.broadcast(x, src=0)
                    ok = bool((x.float() == 1).all()) and x.is_cuda
                else:
                    parts = [torch.empty_like(x) for _ in range(world)]
                    dist.all_gather(parts, x)
                    ok = all(bool((p.float() == i + 1).all()) and p.is_cuda for i, p in enumerate(parts))
                checks[key] = {"ok": ok}
            except Exception as e:  # record which ops gloo refuses
                checks[key] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:500]}
    out["gloo_on_cuda"] = checks
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(MB19, device="cuda").to(dtype)
        name = str(dtype).split(".")[-1]
        if checks[f"all_reduce_{name}"]["ok"]:
            times[f"{name}_cuda_tensor"] = _timed(lambda: dist.all_reduce(x))
        host = x.cpu()

        def staged():
            h = x.cpu()
            dist.all_reduce(h)
            x.copy_(h)

        times[f"{name}_staged_through_host"] = _timed(staged)
        times[f"{name}_host_tensor"] = _timed(lambda: dist.all_reduce(host))
        times[f"{name}_copy_d2h_h2d"] = _timed(lambda: x.copy_(x.cpu()))
        times[f"{name}_mb"] = x.numel() * x.element_size() / 1e6
    out["all_reduce_times"] = times
    print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def launch(mode: str, timeout: float = 150.0) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen([sys.executable, __file__, "rank", mode], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    t = time.perf_counter()
    res = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=max(timeout - (time.perf_counter() - t), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            o, e = p.communicate()
            o += "\n(timed out)"
        lines = [l for l in o.splitlines() if l.startswith("{")]
        res.append({"rc": p.returncode, "report": json.loads(lines[-1]) if lines else None,
                    "stderr_tail": e.splitlines()[-15:]})
    return {"mode": mode, "seconds": time.perf_counter() - t, "ranks": res}


def fork_child(q):
    try:
        torch.zeros(1, device="cuda")
        q.put("ok")
    except Exception as e:  # the error a forked rank meets
        q.put(f"{type(e).__name__}: {e}"[:500])


def main():
    import multiprocessing
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()}), flush=True)
    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()  # the parent has run a kernel
    hold = torch.empty(4 * 2**30, dtype=torch.uint8, device="cuda")
    hold.fill_(1)
    torch.cuda.synchronize()
    del hold
    before = [v / 1e9 for v in torch.cuda.mem_get_info()]
    reserved = torch.cuda.memory_reserved() / 1e9
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = [v / 1e9 for v in torch.cuda.mem_get_info()]
    print(json.dumps({"mem_get_info_gb_free_total": {"before_empty_cache": before,
                                                     "after_empty_cache": after},
                      "reserved_before_gb": reserved}), flush=True)
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=fork_child, args=(q,))
    p.start()
    msg = q.get(timeout=60)
    p.join(60)
    print(json.dumps({"fork_child_cuda": msg, "exitcode": p.exitcode}), flush=True)
    for mode in ("nccl", "gloo"):
        print(json.dumps(launch(mode)), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "rank":
        rank_main(sys.argv[2])
    else:
        main()
