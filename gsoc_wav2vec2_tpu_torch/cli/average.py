"""CLI: average training checkpoints into a servable model (counterpart of
`gsoc_wav2vec2_tpu/cli/average.py`).

Tail averaging of the last N epoch checkpoints that `cli.train` writes
(`<run dir>/stage2`) into a `save_pretrained` directory that every decode
surface accepts (`cli.evaluate`, `cli.transcribe`, the JAX package's too).

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.average \\
        --ckpt_dir <run dir>/stage2 --config <run dir>/final \\
        --last_n 5 --out averaged_model/
"""

from __future__ import annotations

import argparse
import json
import os

from ..models.config import config_from_dict
from ..models.modeling import Wav2Vec2ForCTC
from ..training.checkpoint import average_checkpoint_params


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("checkpoint averaging")
    parser.add_argument("--ckpt_dir", required=True,
                        help="checkpoint dir (e.g. <train run dir>/stage2)")
    parser.add_argument("--config", required=True,
                        help="config.json path, or a model dir containing one")
    parser.add_argument("--out", required=True, help="output model dir")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--last_n", type=int, default=None,
                       help="average the newest N checkpoints (default: all retained)")
    group.add_argument("--steps", type=str, default=None,
                       help="comma-separated checkpoint steps to average")
    args = parser.parse_args(argv)

    config_path = args.config
    if os.path.isdir(config_path):
        config_path = os.path.join(config_path, "config.json")
    with open(config_path) as f:
        config = config_from_dict(json.load(f))
    steps = [int(s) for s in args.steps.split(",") if s] if args.steps is not None else None
    params, used = average_checkpoint_params(args.ckpt_dir, steps=steps, last_n=args.last_n)
    print(f"averaged {len(used)} checkpoints: steps {used}")
    model = Wav2Vec2ForCTC(config, device="cpu")
    model.load_state_dict(params, strict=True)
    model.save_pretrained(args.out)
    print(f"saved averaged model to {args.out}")


if __name__ == "__main__":
    main()
