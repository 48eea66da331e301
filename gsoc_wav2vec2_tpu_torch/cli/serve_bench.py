"""Load benchmark for the serving daemon (`cli.serve`; a port of
`gsoc_wav2vec2_tpu/cli/serve_bench.py`).

N concurrent HTTP clients fire mixed-length utterances at `/v1/transcribe`
and the tool reports client-observed latency percentiles, the server's own
latency, throughput (audio-sec/s and requests/s) and the mean dynamic-batch
occupancy (every response carries `batched_with`, how many requests rode
its forward).

Usage (spawns its own server on the card, then tears it down):
  python -m gsoc_wav2vec2_tpu_torch.cli.serve_bench --model_dir <dir> \
      --clients 8 --requests 64 [--baseline] [--serve_args "--batch_window_ms 10"]

or against an already-running server:
  python -m gsoc_wav2vec2_tpu_torch.cli.serve_bench --url http://127.0.0.1:8057

Prints ONE JSON line with the measured scenario(s).
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np

DEFAULT_LENGTHS = (24000, 60000, 110000, 200000)  # one per default bucket
SAMPLE_RATE = 16000


def wav_bytes(audio_f32: np.ndarray, rate: int = SAMPLE_RATE) -> bytes:
    """16-bit PCM WAV bytes (the daemon's native-decoder payload path)."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(
            (np.clip(audio_f32, -1.0, 1.0) * 32767).astype("<i2").tobytes()
        )
    return buf.getvalue()


def make_payloads(lengths, seed: int = 0) -> list[tuple[float, bytes]]:
    """(audio_seconds, wav_bytes) per length — seeded noise; content does
    not matter for latency, shape does (it picks the bucket)."""
    rng = np.random.default_rng(seed)
    return [
        (n / SAMPLE_RATE, wav_bytes(0.3 * rng.standard_normal(n)))
        for n in lengths
    ]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — no interpolation."""
    s = sorted(values)
    idx = max(0, min(len(s) - 1, int(np.ceil(q / 100.0 * len(s))) - 1))
    return s[idx]


def start_server(argv: list[str], startup_timeout_s: float = 900.0):
    """Spawn `cli.serve` and wait for its 'serving on <url>' line.

    Returns (process, url).  Startup includes loading the model and the
    bucket warmup (on the card: the kernel build), so the timeout is
    generous."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsoc_wav2vec2_tpu_torch.cli.serve", *argv],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        text=True,
    )
    deadline = time.monotonic() + startup_timeout_s
    url = None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"server exited rc={proc.returncode} before serving"
                )
            time.sleep(0.1)
            continue
        if line.startswith("serving on "):
            url = line.split("serving on ", 1)[1].strip()
            break
    if url is None:
        proc.terminate()
        raise RuntimeError(f"server not up within {startup_timeout_s:.0f}s")
    return proc, url


def _post(url: str, body: bytes, timeout_s: float) -> dict:
    req = urllib.request.Request(
        url + "/v1/transcribe", data=body,
        headers={"Content-Type": "audio/wav"},
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def run_load(
    url: str,
    payloads: list[tuple[float, bytes]],
    clients: int,
    requests: int,
    timeout_s: float = 300.0,
    warmup: bool = True,
) -> dict:
    """Fire `requests` total requests from `clients` concurrent threads.

    Request i carries payload i % len(payloads), so the length mix is
    identical across scenarios regardless of thread scheduling."""
    if warmup:
        for _, body in payloads:
            _post(url, body, timeout_s)

    results: list[tuple[float, float, int, float]] = []
    errors: list[str] = []
    lock = threading.Lock()
    counter = iter(range(requests))

    def worker() -> None:
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            audio_s, body = payloads[i % len(payloads)]
            t0 = time.perf_counter()
            try:
                r = _post(url, body, timeout_s)
                client_ms = (time.perf_counter() - t0) * 1000.0
                with lock:
                    results.append(
                        (client_ms, r["latency_ms"], r["batched_with"], audio_s)
                    )
            except (urllib.error.URLError, OSError, KeyError) as e:
                with lock:
                    errors.append(f"{type(e).__name__}: {e}"[:100])

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - start

    if not results:
        return {"clients": clients, "requests": requests,
                "errors": len(errors), "first_error": errors[:1]}
    client_ms = [r[0] for r in results]
    server_ms = [r[1] for r in results]
    occupancy = [r[2] for r in results]
    audio_s = sum(r[3] for r in results)
    out = {
        "clients": clients,
        "requests": len(results),
        "errors": len(errors),
        "wall_s": round(wall_s, 2),
        "audio_sec_per_s": round(audio_s / wall_s, 1),
        "req_per_s": round(len(results) / wall_s, 2),
        "p50_ms": round(percentile(client_ms, 50), 1),
        "p90_ms": round(percentile(client_ms, 90), 1),
        "p99_ms": round(percentile(client_ms, 99), 1),
        "max_ms": round(max(client_ms), 1),
        "server_p50_ms": round(percentile(server_ms, 50), 1),
        "mean_batch_occupancy": round(
            sum(occupancy) / len(occupancy), 2
        ),
    }
    if errors:
        out["first_error"] = errors[0]
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("wav2vec2 serving load benchmark")
    target = parser.add_mutually_exclusive_group(required=True)
    target.add_argument("--model_dir", type=str, help="spawn a server")
    target.add_argument("--url", type=str, help="target a running server")
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--requests", type=int, default=64)
    parser.add_argument(
        "--lengths", type=str,
        default=",".join(map(str, DEFAULT_LENGTHS)),
        help="comma-separated sample lengths cycled across requests",
    )
    parser.add_argument(
        "--baseline", action="store_true",
        help="also run a 1-client sequential pass (the dynamic-batching "
             "win is the audio_sec_per_s ratio)",
    )
    parser.add_argument(
        "--serve_args", type=str, default="",
        help="extra args for the spawned server, e.g. "
             "'--device cpu --batch_window_ms 10'",
    )
    parser.add_argument("--timeout_s", type=float, default=300.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    payloads = make_payloads(
        [int(n) for n in args.lengths.split(",") if n], seed=args.seed
    )

    proc = None
    url = args.url
    if args.model_dir:
        serve_argv = [
            "--model_dir", args.model_dir, "--port", "0",
            *args.serve_args.split(),
        ]
        proc, url = start_server(serve_argv)
    try:
        report = {
            "lengths": [int(n) for n in args.lengths.split(",") if n],
            "load": run_load(
                url, payloads, args.clients, args.requests,
                timeout_s=args.timeout_s,
            ),
        }
        if args.baseline:
            report["batch1"] = run_load(
                url, payloads, 1, max(args.requests // 4, len(payloads)),
                timeout_s=args.timeout_s, warmup=False,
            )
            if report["batch1"].get("audio_sec_per_s"):
                report["batching_speedup"] = round(
                    report["load"]["audio_sec_per_s"]
                    / report["batch1"]["audio_sec_per_s"],
                    2,
                )
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
