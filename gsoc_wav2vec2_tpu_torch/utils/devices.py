"""Device resolution and availability probes for the port.

Entry points run on the card unless the caller asks for the CPU.  There is
no silent fallback: a caller that did not ask for the CPU on a machine
without CUDA gets an error, not a slow run on the host.

`is_gpu_available` / `is_tpu_available` are the counterparts of the JAX
package's probes (`gsoc_wav2vec2_tpu/utils/devices.py`), and like those they
never raise.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means "cuda".  Raises `RuntimeError` when a CUDA device is
    asked for (explicitly or by default) and `torch.cuda.is_available()` is
    false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return dev


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of this process's rank: `device` where it names one
    (`"cpu"`, `"cuda:0"`), else card `LOCAL_RANK` modulo the cards there are
    (torchrun's variable; 0 outside torchrun), so that ranks beyond the
    cards share them.  Resolved as `resolve_device` resolves: a CUDA rank on
    a machine without CUDA raises, it never drops to the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def is_gpu_available() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    try:
        return torch.cuda.is_available() and torch.cuda.device_count() > 0
    except RuntimeError:
        return False


def is_tpu_available() -> bool:
    """Always False: PyTorch here has no TPU backend (the port runs on CUDA
    or the CPU; the JAX package is the one that runs on TPUs)."""
    return False
