"""Rehearse chip_smoke.py's phase 16 (`dist`), or its phases 11 (`serve`)
and 17 (`serve_sharded`), on the CPU at a tiny size.

    python logs/rehearse_dist.py          # phase 16, ~40 s
    python logs/rehearse_dist.py serve    # phases 11 and 17, ~45 s

The parent patches chip_smoke (tiny configs, 8000-sample corpus, the CPU for
the card, no kernel build, launch counts not held: the CPU runs the plain
versions; kernel checks, timings and profiles of the card stubbed) and points
`chip_smoke.__file__` here, so that each rank process runs this file with
`--dist-worker`, applies the same patches and calls `chip_smoke.dist_worker`.
Phase 11 serves and records its replies; phase 17 holds the sharded server's
replies against them, at the default buckets and batch ((8, bucket) on the
leader, (4, bucket) a rank).
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gsoc_wav2vec2_tpu_torch.cli import pretrain as pretrain_cli  # noqa: E402
from gsoc_wav2vec2_tpu_torch.cli import train as train_cli  # noqa: E402
from gsoc_wav2vec2_tpu_torch.models import config as mc  # noqa: E402
from gsoc_wav2vec2_tpu_torch.models import modeling  # noqa: E402
from gsoc_wav2vec2_tpu_torch.utils import devices  # noqa: E402

TINY = dict(vocab_size=32, hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32] * 7, kernal_sizes=[10, 3, 3, 3, 3, 2, 2],
            strides=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
TINY_PT = dict(TINY, num_codevector_groups=2, num_codevectors_per_group=16, codevector_dim=48,
               proj_codevector_dim=40, num_negatives=10)


def patch():
    torch.set_num_threads(1)
    cs.Wav2Vec2Config = lambda **kw: mc.Wav2Vec2Config(**{**TINY, **kw})
    cs.Wav2Vec2PretrainingConfig = lambda **kw: mc.Wav2Vec2PretrainingConfig(**{**TINY_PT, **kw})
    cs.SAMPLES = 8000
    cs.CLI_SHORTEST, cs.CLI_LONGEST, cs.CLI_LABELS = 5000, 8000, (2, 5)
    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    devices.resolve_device = modeling.resolve_device = cpu
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats", "set_device"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.mem_get_info = lambda: (0, 0)
    torch.cuda.memory_reserved = torch.cuda.max_memory_allocated = lambda: 0
    torch.cuda.current_device = lambda: 0
    cs._build.library = lambda: None
    cs.expect_counts = lambda *a: None
    require = cs.require
    cs.require = lambda cond, msg: require(cond or "onto the card" in msg or "on the card" in msg,
                                           msg)
    cs.check_serve_kernels = lambda *a, **k: None
    cs.time_ms = lambda fn, iters, warmup=2: (fn(), 0.0)[1]
    cs.profile_device = lambda fn, reps, unit, top=15: (fn(), {
        "wall_ms_per_pass": 0.0, "device_busy_ms_per_pass": 0.0, "device_idle_share": 0.0,
        "top": [], "device_busy_ms_per_forward": 0.0})[1]
    for cli in (train_cli, pretrain_cli):
        parse = cli.parse_args
        cli.parse_args = lambda argv, parse=parse: parse(list(argv) + ["--compute_dtype", "float32"])


if __name__ == "__main__":
    patch()
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":
        sys.exit(cs.dist_worker(json.loads(sys.argv[2])))
    cs.__file__ = os.path.abspath(__file__)
    t = time.perf_counter()
    if sys.argv[1:] != ["serve"]:
        print(json.dumps(cs.dist_phase("rehearsal on the CPU")), flush=True)
        print("seconds", time.perf_counter() - t)
        sys.exit(0)
    records = [{"name": n, "counter": n, "paths": ("serve",)} for n in cs.SERVE_SHARDED_KERNELS]
    with tempfile.TemporaryDirectory() as root:
        _, one = cs.serve_phase("rehearsal on the CPU", records, root)
        print("phase 11 seconds", time.perf_counter() - t, flush=True)
        t = time.perf_counter()
        launched = cs.serve_sharded_phase("rehearsal on the CPU", records,
                                          os.path.join(root, "model"), one)
    print("phase 17 seconds", time.perf_counter() - t, json.dumps(launched), flush=True)
