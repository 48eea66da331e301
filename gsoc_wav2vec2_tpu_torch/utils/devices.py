"""Device resolution for the port.

Entry points run on the card unless the caller asks for the CPU.  There is
no silent fallback: a caller that did not ask for the CPU on a machine
without CUDA gets an error, not a slow run on the host.
"""

from __future__ import annotations

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
