"""JAX parameter tree <-> the port's state dict.

The port's modules use the JAX tree's names and layouts, so the bridge only
restacks: the JAX tree stacks the encoder layers on a leading axis (for
`lax.scan`) where the port has `encoder.layers.{i}`, and holds the conv
layers in a tuple where the port has `conv_layers.{i}`.  Every state-dict
name is the JAX key path joined with dots.  The pos-conv weight-norm pair
stays (g, v): the recomposition is the port's own code.  The JAX side here
is nested dicts/tuples of numpy arrays (`np.asarray` of a JAX tree's
leaves), or the tree `convert/flax_msgpack.py` decodes (tuples as maps keyed
"0", "1", ..., bfloat16 leaves as torch tensors); this module imports no JAX.
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
        out[prefix[:-1]] = node if isinstance(node, torch.Tensor) else np.asarray(node)


def _tensor(arr) -> torch.Tensor:
    return arr.clone() if isinstance(arr, torch.Tensor) else torch.tensor(arr)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> state dict (copies; dtypes kept).  Leaves that
    are empty tuples (optax's `MaskedNode` of a masked-out leaf) are absent."""
    flat: Dict[str, object] = {}
    _flatten(tree, "", flat)
    out = {}
    for name, arr in flat.items():
        head, sep, rest = name.partition("layers.")
        if sep and not head.endswith("conv_"):
            # stacked encoder layers: one entry per leading index
            for i in range(arr.shape[0]):
                out[f"{head}layers.{i}.{rest}"] = _tensor(arr[i])
        else:
            out[name] = _tensor(arr)
    return out


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    if isinstance(items[0], torch.Tensor):
        return torch.stack(items, dim=0)
    return np.stack(items, axis=0)


def _fold(node, key=None):
    if not isinstance(node, dict):
        return node
    children = {k: _fold(v, k) for k, v in node.items()}
    if children and all(k.isdigit() for k in children):
        items = [children[str(i)] for i in range(len(children))]
        return _stack(items) if key == "layers" else tuple(items)
    return children


def _find_adam(node):
    """The first `ScaleByAdamState`-like node (a namedtuple with count, mu,
    nu) in an optax state tree, through namedtuples, tuples and dicts (the
    containers `multi_transform`, `masked`, `chain` and `inject_hyperparams`
    build their states from)."""
    fields = getattr(node, "_fields", ())
    if {"count", "mu", "nu"} <= set(fields):
        return node
    children = node.values() if isinstance(node, dict) else (
        node if isinstance(node, (list, tuple)) else ())
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def adam_state_from_jax(opt_state, model: torch.nn.Module) -> Dict[torch.nn.Parameter, dict]:
    """optax Adam state (numpy leaves: `jax.tree.map(np.asarray, opt_state)`)
    -> `torch.optim.Adam` per-parameter state, keyed by the model's
    parameters: `optimizer.state.update(adam_state_from_jax(s, model))`.

    Walks to the `ScaleByAdamState` (count, mu, nu) inside
    `multi_transform` / `masked`; its mu and nu are parameter trees whose
    frozen leaves are `MaskedNode`s, so frozen parameters get no state.
    `count` becomes each parameter's `step` (a float32 scalar, as Adam keeps
    it), mu `exp_avg` and nu `exp_avg_sq`.
    """
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    step = float(np.asarray(adam.count))
    params = dict(model.named_parameters())
    out = {}
    for name, m in mu.items():
        p = params[name]
        out[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": m.to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype),
        }
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """State dict -> JAX parameter tree of numpy arrays (encoder layers
    stacked, conv layers a tuple); bfloat16 leaves, which numpy lacks, stay
    CPU torch tensors."""
    tree: dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = t.detach().cpu()
        node[parts[-1]] = t if t.dtype == torch.bfloat16 else t.numpy()
    return _fold(tree)
