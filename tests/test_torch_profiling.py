"""The port's profiling helpers and device probes (`utils/profiling.py`,
`utils/devices.py`) beside the JAX package's, on the CPU."""

import json
import os

import jax.numpy as jnp
import torch

from gsoc_wav2vec2_tpu.utils import devices as jax_devices
from gsoc_wav2vec2_tpu.utils import profiling as jax_profiling
from gsoc_wav2vec2_tpu_torch.utils import devices, profiling

torch.set_num_threads(2)


def test_timeit_forces_execution_and_reads_a_scalar():
    calls = []
    x = torch.ones(64, 64)

    def fn():
        calls.append(1)
        return x @ x

    dt = profiling.timeit(fn, iters=3, warmup=1)
    assert dt > 0 and len(calls) == 4
    # the JAX helper takes the same shape of call
    assert jax_profiling.timeit(lambda: jnp.ones((64, 64)) @ jnp.ones((64, 64)), iters=3, warmup=1) > 0


def test_trace_writes_a_file_that_holds_the_annotation(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.ones(32, 32)
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("w2v2_region"):
            (x @ x).sum().item()
    path = os.path.join(log_dir, profiling.TRACE_NAME)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "w2v2_region" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "w2v2_region" for e in prof.key_averages())


def test_device_probes_never_raise_and_agree_with_jax_on_the_host():
    assert devices.is_tpu_available() is False
    assert devices.is_gpu_available() is torch.cuda.is_available()
    if not torch.cuda.is_available():
        # both packages on this CPU-only host (tests/conftest.py pins JAX to the CPU)
        assert devices.is_gpu_available() is jax_devices.is_gpu_available() is False
