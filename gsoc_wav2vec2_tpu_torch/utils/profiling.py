"""Profiling and timing helpers (counterpart of
`gsoc_wav2vec2_tpu/utils/profiling.py`).

`trace` captures a `torch.profiler` trace of the host and the card and
writes it as a Chrome trace (open it in Perfetto or `chrome://tracing`);
`annotate` names a region in that timeline; `timeit` is the wall time of a
call with completion forced by a scalar readback, since PyTorch returns
before the card has finished.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU activity, and CUDA where a card is present)
    and write `<log_dir>/trace.json`.  Yields the profiler, whose
    `key_averages()` give the time by operator and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def timeit(fn: Callable[[], torch.Tensor], iters: int = 20, warmup: int = 3) -> float:
    """Mean seconds a call of `fn`, which returns a tensor.  The calls run
    back to back; the sum of the last result is read to the host after the
    timed chain, which waits for every call queued before it."""
    for _ in range(warmup):
        fn().sum().item()
    start = time.perf_counter()
    acc: Optional[torch.Tensor] = None
    for _ in range(iters):
        acc = fn().sum()
    acc.item()
    return (time.perf_counter() - start) / iters


def annotate(name: str):
    """A named region in the profiler's timeline (`record_function`)."""
    return record_function(name)
