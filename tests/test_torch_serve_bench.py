"""The port's serving load tool (`cli/serve_bench.py`), on the CPU: its
helpers against the JAX package's, and one end-to-end run that spawns the
port's server (`--device cpu`), drives concurrent mixed-length clients and
the 1-client baseline, prints one JSON line and tears the server down.
Functional checks only: a CPU run's latencies say nothing of the card."""

import io
import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu import Wav2Vec2Config
from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu.cli import serve_bench as jax_bench
from gsoc_wav2vec2_tpu_torch.cli import serve_bench

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def test_percentile_nearest_rank():
    vals = [10.0, 20.0, 30.0, 40.0, 50.0]
    assert serve_bench.percentile(vals, 50) == 30.0
    assert serve_bench.percentile(vals, 99) == 50.0
    assert serve_bench.percentile(vals, 1) == 10.0
    assert serve_bench.percentile([7.0], 99) == 7.0
    rng = np.random.default_rng(0)
    for _ in range(20):
        v = list(rng.standard_normal(int(rng.integers(1, 50))))
        for q in (1, 50, 90, 99, 100):
            assert serve_bench.percentile(v, q) == jax_bench.percentile(v, q)


def test_wav_payloads_match_jax():
    audio = np.sin(np.arange(1600) / 8.0).astype(np.float32)
    raw = serve_bench.wav_bytes(audio)
    with wave.open(io.BytesIO(raw)) as w:
        assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (1, 16000, 1600)
    assert raw == jax_bench.wav_bytes(audio)
    assert serve_bench.make_payloads(serve_bench.DEFAULT_LENGTHS, seed=3) == \
        jax_bench.make_payloads(jax_bench.DEFAULT_LENGTHS, seed=3)
    assert serve_bench.DEFAULT_LENGTHS == jax_bench.DEFAULT_LENGTHS


def test_serve_bench_cli_end_to_end(tmp_path, monkeypatch, capsys):
    """Spawn-server mode: mixed lengths, 4 concurrent clients, the baseline
    pass, one JSON line out, the server gone afterwards."""
    model_dir = str(tmp_path / "model")
    JaxWav2Vec2ForCTC(Wav2Vec2Config(hidden_size=64, num_heads=4, num_layers=2,
                                     intermediate_size=128, filter_sizes=[32, 32],
                                     kernal_sizes=[10, 3], strides=[5, 2], dropout=0.0,
                                     apply_spec_augment=False, survival_prob=1.0),
                      seed=0).save_pretrained(model_dir)
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    spawned = []
    start = serve_bench.start_server

    def recorded(argv, *a, **kw):
        proc, url = start(argv, *a, **kw)
        spawned.append(proc)
        return proc, url

    monkeypatch.setattr(serve_bench, "start_server", recorded)
    serve_bench.main(["--model_dir", model_dir, "--clients", "4", "--requests", "12",
                      "--lengths", "3000,6000", "--baseline", "--serve_args",
                      "--device cpu --buckets 4000,8000 --max_batch 4 --batch_window_ms 300"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["lengths"] == [3000, 6000]
    load = report["load"]
    assert load["requests"] == 12 and load["errors"] == 0
    assert load["p50_ms"] <= load["p99_ms"] <= load["max_ms"]
    assert load["server_p50_ms"] > 0 and load["audio_sec_per_s"] > 0
    assert load["mean_batch_occupancy"] > 1.0  # 4 clients inside a 300 ms window
    b1 = report["batch1"]
    assert b1["errors"] == 0 and b1["clients"] == 1 and b1["mean_batch_occupancy"] == 1.0
    assert report["batching_speedup"] > 0
    assert len(spawned) == 1 and spawned[0].poll() is not None  # the server is gone


def test_start_server_reports_a_server_that_dies(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(RuntimeError, match="exited"):
        serve_bench.start_server(["--model_dir", str(tmp_path / "missing"), "--device", "cpu"],
                                 startup_timeout_s=120)
