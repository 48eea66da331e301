"""Reader for the reference's `tf_model.h5` checkpoint format.

The port's counterpart of `gsoc_wav2vec2_tpu/convert/h5_to_jax.py`.  The
reference saves weights with Keras `save_weights` (reference
`src/wav2vec2/modeling.py:22-27`): each variable is a dataset named by its
TF variable path, e.g.
`wav2vec2-ctc/wav2vec2/encoder/layers/0/attention/q_proj/kernel:0`.  Its
values are in TF layout, which is the JAX parameter tree's layout, so the
reader walks names only, into the tree of `convert/jax_bridge.py`
(`params_to_jax` of the model's state dict gives the template); the
caller turns the result into a state dict with `params_from_jax`.  The
per-layer variables (`encoder/layers/{i}/...`) are stacked along a leading
axis, as the JAX tree stacks them.

`h5py` is imported where a file is read, so the package imports without it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np


def _collect_h5_weights(path: str) -> Dict[str, np.ndarray]:
    """Every dataset in the file, keyed by its TF variable name: the names
    of the groups' `weight_names` attributes where Keras wrote them, else
    the dataset paths."""
    import h5py

    weights: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            weights[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        found_attrs = False
        for layer_group in f.values():
            if hasattr(layer_group, "attrs") and "weight_names" in layer_group.attrs:
                found_attrs = True
                for wname in layer_group.attrs["weight_names"]:
                    wname = wname.decode() if isinstance(wname, bytes) else wname
                    weights[wname] = np.asarray(layer_group[wname])
        if not found_attrs:
            f.visititems(visit)
    return weights


def _strip(name: str) -> str:
    name = name.split(":")[0]
    prefix = "wav2vec2-ctc/"
    return name[len(prefix):] if name.startswith(prefix) else name


def _leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(slash path, leaf) of a nested dict / tuple tree, dict keys sorted
    (the order of `jax.tree_util.tree_flatten_with_path`)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _leaves_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in _leaves_with_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _replace_leaves(tree, values: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_replace_leaves(v, values, f"{prefix}{i}/") for i, v in enumerate(tree))
    return values[prefix[:-1]]


def load_h5_params(path: str, template_params, with_lm_head: bool = True):
    """The JAX-layout parameter tree of `template_params` (numpy leaves),
    filled from the reference H5 checkpoint at `path`.  Raises `KeyError`
    for a variable the file lacks and `ValueError` for a shape that differs."""
    raw = {_strip(k): v for k, v in _collect_h5_weights(path).items()}

    layer_re = re.compile(r"^(wav2vec2/)?encoder/layers/(\d+)/(.+)$")
    flat: Dict[str, np.ndarray] = {}
    per_layer: Dict[str, Dict[int, np.ndarray]] = {}
    for name, value in raw.items():
        m = layer_re.match(name)
        if m:
            key = (m.group(1) or "") + "encoder/layers/" + m.group(3)
            per_layer.setdefault(key, {})[int(m.group(2))] = value
        else:
            flat[name] = value
    for key, by_idx in per_layer.items():
        flat[key] = np.stack([by_idx[i] for i in sorted(by_idx)], axis=0)

    values: Dict[str, np.ndarray] = {}
    missing = []
    for path_name, leaf in _leaves_with_paths(template_params):
        name = path_name
        if not with_lm_head and not name.startswith(("wav2vec2/", "lm_head")):
            name = "wav2vec2/" + name if ("wav2vec2/" + name) in flat else name
        if name in flat:
            value = flat[name]
            if value.shape != tuple(leaf.shape):
                raise ValueError(
                    f"Shape mismatch for {name}: checkpoint {value.shape} vs "
                    f"model {tuple(leaf.shape)}"
                )
            values[path_name] = np.asarray(value, dtype=np.asarray(leaf).dtype)
        else:
            missing.append(name)
            values[path_name] = leaf
    if missing:
        raise KeyError(f"H5 checkpoint is missing variables: {missing[:10]}")
    return _replace_leaves(template_params, values)
