"""Reference numpy evaluator for ONNX graphs (no onnxruntime needed).

The port's copy of `gsoc_wav2vec2_tpu/export/onnx_numpy.py`.  It executes
the op subset `onnx_export.py` emits, plus the ops torch's own exporter
emits for the HF wav2vec2 model (the JAX package's tests validate it
against such a file).  A validation runtime: clarity over speed; the
serving artifact on the card is `export/torch_export.py`'s.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import onnx_proto as P

_erf = np.frompyfunc(math.erf, 1, 1)


def _erf32(x: np.ndarray) -> np.ndarray:
    return _erf(x.astype(np.float64)).astype(np.float32)


class OnnxModel:
    """Parse + execute an ONNX ModelProto with numpy semantics."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            blob = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                blob = f.read()
        self.model = P.decode_model(blob)
        for opset in self.model.get("opset_import", []):
            if opset.get("domain", "") in ("", "ai.onnx") and opset["version"] > 20:
                raise ValueError(f"opset {opset['version']} newer than supported")
        self.graph = self.model["graph"]
        self.initializers: Dict[str, np.ndarray] = {
            t["name"]: P.array_from_tensor(t)
            for t in self.graph.get("initializer", [])
        }
        self.input_names = [
            vi["name"]
            for vi in self.graph.get("input", [])
            if vi["name"] not in self.initializers
        ]
        self.output_names = [vi["name"] for vi in self.graph.get("output", [])]

    # -- execution ---------------------------------------------------------

    def run(self, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Execute the graph; returns outputs in graph order."""
        env: Dict[str, np.ndarray] = dict(self.initializers)
        for name in self.input_names:
            if name not in feeds:
                raise ValueError(f"missing graph input {name!r}")
        for name, value in feeds.items():
            env[name] = np.asarray(value)
        for node in self.graph.get("node", []):
            op = node["op_type"]
            fn = _OPS.get(op)
            if fn is None:
                raise NotImplementedError(f"ONNX op {op!r} not implemented")
            attrs = _attrs(node)
            inputs = [env[n] if n else None for n in node.get("input", [])]
            outputs = fn(attrs, *inputs)
            if not isinstance(outputs, tuple):
                outputs = (outputs,)
            for name, value in zip(node["output"], outputs):
                if name:
                    env[name] = value
        return [env[n] for n in self.output_names]


def _attrs(node: dict) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for a in node.get("attribute", []):
        t = a.get("type")
        if t == P.ATTR_FLOAT:
            out[a["name"]] = a.get("f", 0.0)
        elif t == P.ATTR_INT:
            out[a["name"]] = a.get("i", 0)
        elif t == P.ATTR_STRING:
            out[a["name"]] = a.get("s", b"").decode("utf-8")
        elif t == P.ATTR_TENSOR:
            out[a["name"]] = P.array_from_tensor(a["t"])
        elif t == P.ATTR_INTS:
            out[a["name"]] = list(a.get("ints", []))
        elif t == P.ATTR_FLOATS:
            out[a["name"]] = list(a.get("floats", []))
        else:
            raise NotImplementedError(f"attribute type {t} ({a.get('name')})")
    return out


# ---------------------------------------------------------------------------
# Op implementations
# ---------------------------------------------------------------------------


def _op_conv(attrs, x, w, b=None):
    """1-D Conv (N, C, L): the only spatial rank wav2vec2 uses."""
    if x.ndim != 3:
        raise NotImplementedError("only Conv1d supported")
    group = attrs.get("group", 1)
    (stride,) = attrs.get("strides", [1]) or [1]
    dil = attrs.get("dilations", [1]) or [1]
    if dil != [1]:
        raise NotImplementedError("dilations != 1")
    pads = attrs.get("pads", [0, 0]) or [0, 0]
    if pads != [0, 0]:
        x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[1])))
    k = w.shape[-1]
    win = np.lib.stride_tricks.sliding_window_view(x, k, axis=2)[:, :, ::stride]
    cin_g = w.shape[1]
    m_g = w.shape[0] // group
    outs = []
    for g in range(group):
        wg = w[g * m_g : (g + 1) * m_g]  # (M_g, C_in/g, k)
        xg = win[:, g * cin_g : (g + 1) * cin_g]  # (B, C_in/g, L', k)
        outs.append(np.einsum("bclk,mck->bml", xg, wg, dtype=np.float32))
    y = np.concatenate(outs, axis=1).astype(x.dtype)
    if b is not None:
        y = y + b[None, :, None]
    return y


def _op_layer_norm(attrs, x, scale, bias=None):
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-5)
    if axis < 0:
        axis += x.ndim
    axes = tuple(range(axis, x.ndim))
    x32 = x.astype(np.float32)
    mean = x32.mean(axis=axes, keepdims=True)
    var = ((x32 - mean) ** 2).mean(axis=axes, keepdims=True)
    y = (x32 - mean) / np.sqrt(var + eps) * scale.astype(np.float32)
    if bias is not None:
        y = y + bias.astype(np.float32)
    return y.astype(x.dtype)


def _op_instance_norm(attrs, x, scale, bias):
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    x32 = x.astype(np.float32)
    mean = x32.mean(axis=axes, keepdims=True)
    var = ((x32 - mean) ** 2).mean(axis=axes, keepdims=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x32 - mean) / np.sqrt(var + eps)
    return (y * scale.reshape(shape) + bias.reshape(shape)).astype(x.dtype)


def _op_softmax(attrs, x):
    axis = attrs.get("axis", -1)
    x32 = x.astype(np.float32)
    x32 = x32 - x32.max(axis=axis, keepdims=True)
    e = np.exp(x32)
    return (e / e.sum(axis=axis, keepdims=True)).astype(x.dtype)


def _op_reshape(attrs, x, shape):
    target = [int(s) for s in shape]
    if not attrs.get("allowzero", 0):
        target = [x.shape[i] if s == 0 else s for i, s in enumerate(target)]
    return x.reshape(target)


def _op_slice(attrs, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset <10 attribute form
        starts = attrs["starts"]
        ends = attrs["ends"]
        axes = attrs.get("axes")
    starts = [int(v) for v in np.atleast_1d(starts)]
    ends = [int(v) for v in np.atleast_1d(ends)]
    axes = (
        list(range(len(starts)))
        if axes is None
        else [int(v) for v in np.atleast_1d(axes)]
    )
    steps = [1] * len(starts) if steps is None else [int(v) for v in np.atleast_1d(steps)]
    slicer: List[Any] = [slice(None)] * x.ndim
    int64_max = (1 << 63) - 1
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        if ax < 0:
            ax += x.ndim
        en = None if en >= int64_max - 1 else en
        slicer[ax] = slice(st, en, sp)
    return x[tuple(slicer)]


def _op_gemm(attrs, a, b, c=None):
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    y = alpha * (a @ b)
    if c is not None:
        y = y + beta * c
    return y.astype(a.dtype)


def _op_cast(attrs, x):
    np_dtype = P._ONNX_TO_NP.get(attrs["to"])
    if np_dtype is None:
        raise NotImplementedError(f"Cast to {attrs['to']}")
    return x.astype(np_dtype)


def _reduce(np_fn):
    def fn(attrs, x, axes=None):
        if axes is None:
            axes = attrs.get("axes")  # opset <13/<18 attribute form
        keepdims = bool(attrs.get("keepdims", 1))
        if axes is None or (hasattr(axes, "__len__") and len(axes) == 0):
            if attrs.get("noop_with_empty_axes", 0) and axes is not None:
                return x
            return np_fn(x, axis=None, keepdims=keepdims)
        axes = tuple(int(a) for a in np.atleast_1d(axes))
        return np_fn(x, axis=axes, keepdims=keepdims)

    return fn


def _op_unsqueeze(attrs, x, axes=None):
    if axes is None:
        axes = attrs["axes"]
    for a in sorted(int(v) for v in np.atleast_1d(axes)):
        x = np.expand_dims(x, a if a >= 0 else a + x.ndim + 1)
    return x


def _op_squeeze(attrs, x, axes=None):
    if axes is None:
        axes = attrs.get("axes")
    if axes is None:
        return np.squeeze(x)
    axes = tuple(int(a) % x.ndim for a in np.atleast_1d(axes))
    return np.squeeze(x, axis=axes)


def _op_constant(attrs):
    if "value" in attrs:
        return attrs["value"]
    if "value_float" in attrs:
        return np.float32(attrs["value_float"])
    if "value_int" in attrs:
        return np.int64(attrs["value_int"])
    if "value_ints" in attrs:
        return np.asarray(attrs["value_ints"], np.int64)
    if "value_floats" in attrs:
        return np.asarray(attrs["value_floats"], np.float32)
    raise NotImplementedError("Constant without a supported value attribute")


def _op_constant_of_shape(attrs, shape):
    value = attrs.get("value")
    if value is None:
        value = np.zeros((1,), np.float32)
    return np.full([int(s) for s in shape], value.reshape(-1)[0], dtype=value.dtype)


def _op_expand(attrs, x, shape):
    target = np.broadcast_shapes(x.shape, tuple(int(s) for s in shape))
    return np.broadcast_to(x, target)


def _op_split(attrs, x, split=None):
    axis = attrs.get("axis", 0)
    if split is None and "split" in attrs:
        split = attrs["split"]
    if split is None:
        n = attrs["num_outputs"]
        return tuple(np.array_split(x, n, axis=axis))
    sections = np.cumsum([int(s) for s in np.atleast_1d(split)])[:-1]
    return tuple(np.split(x, sections, axis=axis))


def _op_pow(attrs, x, y):
    return np.power(x, y.astype(x.dtype)).astype(x.dtype)


_OPS = {
    "Conv": _op_conv,
    "MatMul": lambda a, x, y: np.matmul(x, y),
    "Gemm": _op_gemm,
    "Add": lambda a, x, y: x + y,
    "Sub": lambda a, x, y: x - y,
    "Mul": lambda a, x, y: x * y,
    "Div": lambda a, x, y: (
        # int64 Div is C-style truncation; float is ordinary division
        np.trunc(x / y).astype(x.dtype) if np.issubdtype(x.dtype, np.integer) else x / y
    ),
    "Pow": _op_pow,
    "Sqrt": lambda a, x: np.sqrt(x),
    "Erf": lambda a, x: _erf32(x),
    "Tanh": lambda a, x: np.tanh(x),
    "Relu": lambda a, x: np.maximum(x, 0),
    "Sigmoid": lambda a, x: (1.0 / (1.0 + np.exp(-x.astype(np.float32)))).astype(x.dtype),
    "Neg": lambda a, x: -x,
    "Not": lambda a, x: np.logical_not(x),
    "Identity": lambda a, x: x,
    "Softmax": _op_softmax,
    "Transpose": lambda a, x: np.transpose(x, a.get("perm")),
    "Reshape": _op_reshape,
    "Slice": _op_slice,
    "Concat": lambda a, *xs: np.concatenate(xs, axis=a["axis"]),
    "Unsqueeze": _op_unsqueeze,
    "Squeeze": _op_squeeze,
    "Shape": lambda a, x: np.asarray(x.shape, np.int64),
    "Gather": lambda a, x, idx: np.take(x, idx.astype(np.int64), axis=a.get("axis", 0)),
    "Cast": _op_cast,
    "Less": lambda a, x, y: np.less(x, y),
    "Greater": lambda a, x, y: np.greater(x, y),
    "Equal": lambda a, x, y: np.equal(x, y),
    "Where": lambda a, c, x, y: np.where(c, x, y),
    "Expand": _op_expand,
    "ConstantOfShape": _op_constant_of_shape,
    "Range": lambda a, s, l, d: np.arange(s, l, d),
    "ReduceSum": _reduce(np.sum),
    "ReduceMean": _reduce(np.mean),
    "ReduceMax": _reduce(np.max),
    "InstanceNormalization": _op_instance_norm,
    "LayerNormalization": _op_layer_norm,
    "Constant": _op_constant,
    "Split": _op_split,
}
