"""What a training run sets so that a resumed run is the straight run bit for bit.

The port's kernels add in a fixed order, but in f32 (and wherever
`pos_conv.supports` is false in bf16) the pos conv is a plain grouped conv
through cuDNN, and the front end trained in pretraining is plain convs too.
cuDNN's default backward algorithms may sum with atomics, and then two
identical steps give different `weight_g` / `weight_v` gradients.
`torch.use_deterministic_algorithms(True)` is not set: it raises on ops the
port uses on purpose (`index_add_`, whose order the sums do not depend on
where the port calls it).
"""

from __future__ import annotations

import torch


def deterministic_training() -> None:
    """Have cuDNN take deterministic algorithms, chosen without benchmarking
    (`cudnn.benchmark` picks by timing, which can differ from run to run).
    The training CLIs call it before they build a model."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
