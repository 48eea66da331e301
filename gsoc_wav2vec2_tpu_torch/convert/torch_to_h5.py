"""Writer for the reference's `tf_model.h5` checkpoint format.

The port's counterpart of `gsoc_wav2vec2_tpu/convert/jax_to_h5.py`: a model
fine-tuned with the port loads in the reference's Keras
`Wav2Vec2ForCTC.from_pretrained` (which calls `load_weights`, reference
`src/wav2vec2/modeling.py:22-27,82`) and in the JAX package's
`from_pretrained`.

Keras-2 `load_weights` matches weights by ORDER, not name: it zips each
saved group's `weight_names` list against the layer's `layer.weights`.  So
the file keeps the JAX writer's layout: groups [wav2vec2, dropout, lm_head,
top_level_model_weights], in-group variable order: conv stack -> feature
projection -> pos-conv (weight_v, bias, weight_g) -> encoder layer-norm ->
per-layer attention/norm/FFN -> masked_spec_embed last.  The values come
from the JAX-layout tree (`params_to_jax(model.state_dict())`).

`h5py` is imported where a file is written, so the package imports without it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..models.config import Wav2Vec2Config


def _ordered_wav2vec2_names(config: Wav2Vec2Config) -> List[str]:
    """Variable paths (JAX parameter-tree paths) in the reference's
    `layer.weights` order for the `wav2vec2` sublayer."""
    names: List[str] = []
    for i in range(len(config.filter_sizes)):
        names.append(f"feature_extractor/conv_layers/{i}/conv/kernel")
        if config.conv_bias:
            names.append(f"feature_extractor/conv_layers/{i}/conv/bias")
        if (config.feature_extractor_norm_type == "group" and i == 0) or (
            config.feature_extractor_norm_type == "layer"
        ):
            names.append(f"feature_extractor/conv_layers/{i}/layer_norm/gamma")
            names.append(f"feature_extractor/conv_layers/{i}/layer_norm/beta")
    names += [
        "feature_projection/layer_norm/gamma",
        "feature_projection/layer_norm/beta",
        "feature_projection/projection/kernel",
        "feature_projection/projection/bias",
        "encoder/pos_conv_embed/conv/weight_v",
        "encoder/pos_conv_embed/conv/bias",
        "encoder/pos_conv_embed/conv/weight_g",
        "encoder/layer_norm/gamma",
        "encoder/layer_norm/beta",
    ]
    for i in range(config.num_layers):
        base = f"encoder/layers/{i}"
        names += [
            f"{base}/attention/q_proj/kernel",
            f"{base}/attention/q_proj/bias",
            f"{base}/attention/k_proj/kernel",
            f"{base}/attention/k_proj/bias",
            f"{base}/attention/v_proj/kernel",
            f"{base}/attention/v_proj/bias",
            f"{base}/attention/out_proj/kernel",
            f"{base}/attention/out_proj/bias",
            f"{base}/layer_norm/gamma",
            f"{base}/layer_norm/beta",
            f"{base}/feed_forward/intermediate_dense/kernel",
            f"{base}/feed_forward/intermediate_dense/bias",
            f"{base}/feed_forward/output_dense/kernel",
            f"{base}/feed_forward/output_dense/bias",
            f"{base}/final_layer_norm/gamma",
            f"{base}/final_layer_norm/beta",
        ]
    names.append("masked_spec_embed")
    return names


def _lookup(params, path: str) -> np.ndarray:
    """A leaf by slash path, as f32 numpy; `encoder/layers/{i}/...` indexes
    the stacked arrays along their leading (layer) axis."""
    parts = path.split("/")
    node = params
    layer_idx = None
    i = 0
    while i < len(parts):
        key = parts[i]
        if key == "layers" and layer_idx is None and i + 1 < len(parts):
            node = node["layers"]
            layer_idx = int(parts[i + 1])
            i += 2
            continue
        if isinstance(node, (list, tuple)):
            node = node[int(key)]
        else:
            node = node[key]
        i += 1
    if isinstance(node, torch.Tensor):  # `params_to_jax` keeps bf16 leaves as tensors
        node = node.detach().cpu().float().numpy()
    value = np.asarray(node, np.float32)
    if layer_idx is not None:
        value = value[layer_idx]
    return value


def save_h5_params(
    params, config: Wav2Vec2Config, path: str, with_lm_head: bool = True
) -> None:
    """Write the JAX-layout tree `params` as a reference-compatible
    `tf_model.h5`."""
    import h5py

    if not with_lm_head:
        # the reference's headless Wav2Vec2Model has a different Keras layer
        # topology (conv layers at the top level); only the CTC layout is
        # verified against its save_weights output
        raise NotImplementedError(
            "reference-compatible H5 export covers Wav2Vec2ForCTC only; "
            "use the native msgpack format for the headless model"
        )
    if not config.feat_proj_layer_norm:
        # the reference's Keras model always has this LayerNorm; a HuBERT
        # checkpoint without it has no valid reference H5 representation
        raise ValueError(
            "reference H5 export requires feat_proj_layer_norm=True; "
            "use the native msgpack format for this model"
        )
    root = "wav2vec2-ctc"
    tree = params["wav2vec2"]

    def attr(names: List[str]) -> np.ndarray:
        return np.asarray([n.encode("utf8") for n in names])

    groups: List[Tuple[str, List[Tuple[str, np.ndarray]]]] = []
    w_entries = [
        (f"{root}/wav2vec2/{p}:0", _lookup(tree, p))
        for p in _ordered_wav2vec2_names(config)
    ]
    groups.append(("wav2vec2", w_entries))
    groups.append(("dropout", []))
    groups.append(
        (
            "lm_head",
            [
                (f"{root}/lm_head/kernel:0", _lookup(params, "lm_head/kernel")),
                (f"{root}/lm_head/bias:0", _lookup(params, "lm_head/bias")),
            ],
        )
    )

    with h5py.File(path, "w") as f:
        f.attrs["backend"] = "tensorflow"
        f.attrs["layer_names"] = attr([g for g, _ in groups])
        for gname, entries in groups:
            g = f.create_group(gname)
            g.attrs["weight_names"] = attr([n for n, _ in entries])
            for name, value in entries:
                g.create_dataset(name, data=value)
        f.create_group("top_level_model_weights").attrs["weight_names"] = attr([])
