"""JAX parameter tree <-> the port's state dict.

The port's modules use the JAX tree's names and layouts, so the bridge only
restacks: the JAX tree stacks the encoder layers on a leading axis (for
`lax.scan`) where the port has `encoder.layers.{i}`, and holds the conv
layers in a tuple where the port has `conv_layers.{i}`.  Every state-dict
name is the JAX key path joined with dots.  The pos-conv weight-norm pair
stays (g, v): the recomposition is the port's own code.  The JAX side here
is nested dicts/tuples of numpy arrays (`np.asarray` of a JAX tree's
leaves); this module imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(node, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(node)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> state dict (copies; dtypes kept)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    out = {}
    for name, arr in flat.items():
        head, sep, rest = name.partition("layers.")
        if sep and not head.endswith("conv_"):
            # stacked encoder layers: one entry per leading index
            for i in range(arr.shape[0]):
                out[f"{head}layers.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            out[name] = torch.tensor(arr)
    return out


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items, axis=0)


def _fold(node, key=None):
    if not isinstance(node, dict):
        return node
    children = {k: _fold(v, k) for k, v in node.items()}
    if children and all(k.isdigit() for k in children):
        items = [children[str(i)] for i in range(len(children))]
        return _stack(items) if key == "layers" else tuple(items)
    return children


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """State dict -> JAX parameter tree of numpy arrays (encoder layers
    stacked, conv layers a tuple)."""
    tree: dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().cpu().numpy()
    return _fold(tree)
