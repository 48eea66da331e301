"""HuggingFace `transformers` state dict -> the port's state dict.

The port's own copy of the HF name map of
`gsoc_wav2vec2_tpu/convert/torch_to_jax.py`.  The port keeps the JAX
package's parameter layouts, so the layout transposes live here:

  * 2-D `weight` matrices (out, in) -> `kernel` (in, out);
  * feature-extractor conv weights (out, in, K) -> `kernel` (K, in, out);
  * the pos-conv weight-norm pair stays (g, v), each (2, 1, 0)-transposed
    (g: (1, 1, K) -> (K, 1, 1));
  * `layer_norm.weight`/`bias` -> `gamma`/`beta`.

Both the legacy `weight_g`/`weight_v` names and the modern
`parametrizations.weight.original0/1` names are read, under a `wav2vec2.`
or `hubert.` backbone prefix (or none, for bare backbone checkpoints).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _transpose2(t: torch.Tensor) -> torch.Tensor:
    return t.t()


def _transpose3(t: torch.Tensor) -> torch.Tensor:
    return t.permute(2, 1, 0)


def hf_name_map(config, with_lm_head: bool, prefix: str) -> Dict[str, Tuple[str, Callable]]:
    """Port name -> (HF name, transform), for every parameter the port's
    model of `config` holds (optional ones included; the caller drops the
    absent)."""
    m: Dict[str, Tuple[str, Callable]] = {}
    back = "wav2vec2." if with_lm_head else ""

    def dense(ours: str, theirs: str):
        m[f"{ours}.kernel"] = (f"{theirs}.weight", _transpose2)
        m[f"{ours}.bias"] = (f"{theirs}.bias", _same)

    def norm(ours: str, theirs: str):
        m[f"{ours}.gamma"] = (f"{theirs}.weight", _same)
        m[f"{ours}.beta"] = (f"{theirs}.bias", _same)

    for i in range(len(config.filter_sizes)):
        base = f"feature_extractor.conv_layers.{i}"
        m[f"{back}{base}.conv.kernel"] = (f"{prefix}{base}.conv.weight", _transpose3)
        m[f"{back}{base}.conv.bias"] = (f"{prefix}{base}.conv.bias", _same)
        norm(f"{back}{base}.layer_norm", f"{prefix}{base}.layer_norm")
    norm(f"{back}feature_projection.layer_norm", f"{prefix}feature_projection.layer_norm")
    dense(f"{back}feature_projection.projection", f"{prefix}feature_projection.projection")
    m[f"{back}masked_spec_embed"] = (f"{prefix}masked_spec_embed", _same)
    pc = "encoder.pos_conv_embed.conv"
    m[f"{back}{pc}.weight_v"] = (f"{prefix}{pc}.weight_v", _transpose3)
    m[f"{back}{pc}.weight_g"] = (f"{prefix}{pc}.weight_g", _transpose3)
    m[f"{back}{pc}.bias"] = (f"{prefix}{pc}.bias", _same)
    norm(f"{back}encoder.layer_norm", f"{prefix}encoder.layer_norm")
    for i in range(config.num_layers):
        base = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{back}{base}.attention.{name}", f"{prefix}{base}.attention.{name}")
        norm(f"{back}{base}.layer_norm", f"{prefix}{base}.layer_norm")
        for name in ("intermediate_dense", "output_dense"):
            dense(f"{back}{base}.feed_forward.{name}", f"{prefix}{base}.feed_forward.{name}")
        norm(f"{back}{base}.final_layer_norm", f"{prefix}{base}.final_layer_norm")
    if with_lm_head:
        dense("lm_head", "lm_head")
    return m


def state_dict_from_hf(
    state_dict: Dict[str, torch.Tensor], config, with_lm_head: bool = True
) -> Dict[str, torch.Tensor]:
    """The port's state dict (f32 tensors) from an HF `Wav2Vec2ForCTC` /
    `Wav2Vec2Model` (or HuBERT) state dict."""
    sd = {
        k.replace("parametrizations.weight.original0", "weight_g")
        .replace("parametrizations.weight.original1", "weight_v"): v
        for k, v in state_dict.items()
    }
    prefix = next((p for p in ("wav2vec2.", "hubert.") if any(k.startswith(p) for k in sd)), "")
    out = {}
    for ours, (theirs, transform) in hf_name_map(config, with_lm_head, prefix).items():
        if theirs in sd:
            out[ours] = transform(sd[theirs]).float().contiguous()
    spec = ("wav2vec2." if with_lm_head else "") + "masked_spec_embed"
    if spec not in out:
        # inference-only checkpoints may omit it; only SpecAugment reads it
        out[spec] = torch.zeros(config.hidden_size)
    return out
