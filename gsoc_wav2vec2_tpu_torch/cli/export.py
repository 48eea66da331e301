"""CLI: export a checkpoint for serving.

Counterpart of `gsoc_wav2vec2_tpu/cli/export.py` (and of the reference's
`src/export2hub.py`), with the same flags plus `--device`.  Formats:
  * `--format torch_export` (default): a `torch.export` program with a
    symbolic batch (`export/torch_export.py`), the kernels kept in the graph
    as `torch.library` operators; it runs on the device type it was
    exported on;
  * `--format onnx`: a literal `.onnx` ModelProto built op by op
    (`export/onnx_export.py`), float32 semantics, byte-equal to the JAX
    package's for the same weights;
  * `--format saved_model`: a TF SavedModel (`export/savedmodel.py`), what
    the reference published to TFHub: the ONNX builder's graph evaluated
    with TF ops, the weights as TF variables, in `--compute_dtype` (bf16 by
    default, as the JAX CLI).  It needs TensorFlow (the card's machine has
    none: there the format raises ImportError).

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.export \\
        --model_id <dir-or-hub-id> --saved_model_dir out/ --seqlen 246000
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..convert.jax_bridge import params_to_jax
from ..models.modeling import Wav2Vec2ForCTC, Wav2Vec2Model


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Export wav2vec2 to a torch.export, TF SavedModel or ONNX "
                                     "artifact")
    parser.add_argument("--model_id", required=True, type=str)
    parser.add_argument("--saved_model_dir", required=True, type=str)
    parser.add_argument("--seqlen", type=int, default=246000)
    parser.add_argument("--batch_size", type=int, default=0, help="0 = symbolic (any batch)")
    parser.add_argument("--with_lm_head", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16")
    parser.add_argument("--format", type=str, default="torch_export",
                        choices=["torch_export", "saved_model", "onnx"])
    parser.add_argument("--device", type=str, default=None,
                        help="where the model loads and the program is traced (default: cuda)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Export as `argv` asks; returns the artifact's path."""
    args = parse_args(argv)
    cls = Wav2Vec2ForCTC if args.with_lm_head else Wav2Vec2Model
    model = cls.from_pretrained(args.model_id, device=args.device)
    if args.format == "onnx":
        from ..export.onnx_export import export_onnx

        path = export_onnx(model.config, params_to_jax(model.state_dict()), args.saved_model_dir,
                           seqlen=args.seqlen, with_lm_head=args.with_lm_head)
    elif args.format == "saved_model":
        from ..export.savedmodel import export_saved_model

        path = export_saved_model(model.config, params_to_jax(model.state_dict()),
                                  args.saved_model_dir, seqlen=args.seqlen,
                                  with_lm_head=args.with_lm_head,
                                  compute_dtype=args.compute_dtype)
    else:
        from ..export.torch_export import export_model

        path = export_model(model, args.saved_model_dir, seqlen=args.seqlen,
                            batch_size=args.batch_size or None, with_lm_head=args.with_lm_head,
                            compute_dtype=getattr(torch, args.compute_dtype))
    print(f"exported to {path}")
    return path


if __name__ == "__main__":
    main()
