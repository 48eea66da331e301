"""CLI: convert an HF PyTorch checkpoint (wav2vec2 or HuBERT) to this
framework's format.

Counterpart of `gsoc_wav2vec2_tpu/cli/convert.py` (the reference's
`src/convert_torch_to_tf.py`), with the same flags plus `--device`.  The
output directory (config.json + jax_model.msgpack) loads through either
package's `from_pretrained`.  HuBERT checkpoints (e.g.
facebook/hubert-large-ls960-ft) are detected from the HF config's
`model_type`; they share the backbone.  Before writing, the converted model
runs an f32 forward of 8000 samples of `RandomState(0)` noise on `--device`
(TF32 off) against the `transformers` model's, and the conversion fails
unless the largest difference is under 0.004.  Needs `transformers`.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.convert \\
        --model_id facebook/wav2vec2-base-960h [--out jax-wav2vec2-base-960h]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from ..convert.hf_torch import state_dict_from_hf
from ..models.config import RobustWav2Vec2Config, config_from_hf_dict
from ..models.modeling import Wav2Vec2ForCTC, Wav2Vec2Model
from ..utils.devices import resolve_device

PARITY_ATOL = 0.004


def convert(model_id: str, out_dir: str, with_lm_head: bool = True, robust: bool = False,
            verify: bool = True, device=None) -> str:
    """Convert `model_id` (an HF hub id or a local HF directory) into
    `out_dir`; returns `out_dir`."""
    import transformers

    dev = resolve_device(device)
    hf_cfg = transformers.AutoConfig.from_pretrained(model_id)
    if hf_cfg.model_type == "hubert":
        hf_cls = transformers.HubertForCTC if with_lm_head else transformers.HubertModel
    else:
        hf_cls = transformers.Wav2Vec2ForCTC if with_lm_head else transformers.Wav2Vec2Model
    hf_model = hf_cls.from_pretrained(model_id).eval()

    config = config_from_hf_dict(hf_model.config.to_dict())
    if robust and not config.is_robust:
        # mark a checkpoint mask-aware without changing the HF-derived norm
        # types (the reference's robust flag)
        config = RobustWav2Vec2Config(**{**config.__dict__, "is_robust": True})
    cls = Wav2Vec2ForCTC if with_lm_head else Wav2Vec2Model
    model = cls(config, device="cpu")
    model.load_state_dict(state_dict_from_hf(hf_model.state_dict(), config,
                                             with_lm_head=with_lm_head), strict=True)
    model.to(dev)

    if verify:
        speech = np.random.RandomState(0).randn(1, 8000).astype(np.float32)
        with torch.no_grad():
            hf_out = hf_model(torch.from_numpy(speech))
            expected = (hf_out.logits if with_lm_head else hf_out.last_hidden_state).numpy()
            with torch.backends.cudnn.flags(allow_tf32=False):
                got = type(model)._forward(model, config, torch.from_numpy(speech).to(dev),
                                           compute_dtype=torch.float32).cpu().numpy()
        atol = float(np.abs(got - expected).max())
        print(f"conversion max abs diff vs torch: {atol:.2e}")
        if not atol < PARITY_ATOL:
            raise RuntimeError(f"conversion parity check failed: {atol:.2e} >= {PARITY_ATOL}")

    model.save_pretrained(out_dir)
    print(f"saved to {out_dir}")
    return out_dir


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser("Convert an HF torch wav2vec2 / HuBERT checkpoint")
    parser.add_argument("--model_id", required=True, type=str)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--with_lm_head", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--robust", action="store_true")
    parser.add_argument("--no-verify", dest="verify", action="store_false")
    parser.add_argument("--device", type=str, default=None,
                        help="where the parity forward runs (default: cuda)")
    args = parser.parse_args(argv)
    out = args.out or f"jax-{os.path.basename(args.model_id.rstrip('/'))}"
    return convert(args.model_id, out, args.with_lm_head, args.robust, args.verify, args.device)


if __name__ == "__main__":
    main()
