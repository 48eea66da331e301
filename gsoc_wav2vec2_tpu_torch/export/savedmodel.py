"""TF SavedModel export: the reference's TFHub artifact (`export2hub.py`),
the counterpart of `gsoc_wav2vec2_tpu/export/savedmodel.py`.

The JAX package lowers its forward through jax2tf; the port has no JAX, so
it evaluates the graph that `onnx_export.build_wav2vec2_onnx` builds, node by
node with TF ops inside one `tf.function`, as `onnx_numpy.py` evaluates it
with numpy.  The SavedModel, the `.onnx` file and the numpy evaluator thus
compute one graph (for float32; a bf16 SavedModel evaluates the builder's
bf16 graph, which has the JAX bf16 forward's casts and tanh GELU).  The
graph's parameters (its float initializers of rank >= 1) become
`tf.Variable`s tracked by the module, as the JAX export's `param_vars` are,
so a TFHub user can fine-tune them; the positional conv's weight norm is
folded into its kernel, as in the ONNX graph.  Shapes, indices and scalar
constants stay constants.

The artifact's contract is the JAX artifact's: the signature
`serving_default` takes `speech` float32 `[None, seqlen]` (a symbolic batch,
a fixed length) and, for robust configs, `attention_mask` float32 of the
same shape; its one output is `output_0` (the logits, or the hidden states
without the LM head); the loaded object is callable,
`tf.saved_model.load(d)(tf.constant(speech))`.

TensorFlow is imported inside `export_saved_model` only: the package imports
without it, and the card's machine has none (the format raises ImportError
there).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ..models.config import Wav2Vec2Config
from . import onnx_proto as P
from .onnx_export import build_wav2vec2_onnx
from .onnx_numpy import _attrs


def _tf_ops(tf):
    """The graph's operators as TF functions `(attrs, *inputs) -> output`.
    Constant operands (shapes, slice bounds, the mask's frame indices) arrive
    as numpy arrays."""
    dtypes = {P.FLOAT: tf.float32, P.BFLOAT16: tf.bfloat16, P.INT64: tf.int64}

    def reshape(a, x, shape):
        target = [int(s) for s in shape]
        return tf.reshape(x, [tf.shape(x)[i] if s == 0 else s for i, s in enumerate(target)])

    def conv(a, x, w, b=None):
        """ONNX Conv over (N, C, L), as `onnx_numpy._op_conv`: to (N, L, C),
        `tf.nn.conv1d` with the kernel as (k, C_in / groups, C_out) (TF
        groups by the channel ratio), back to (N, C, L).  bf16 operands are
        convolved in f32 and the result rounded to bf16 (the sums of an
        f32-accumulating bf16 convolution): TF 2.21's CPU bf16 convolution
        gave sums off by more than their own size at the pos conv's 128 taps."""
        dtype = x.dtype
        (stride,) = a.get("strides", [1])
        pads = a.get("pads", [0, 0])
        x = tf.transpose(tf.cast(x, tf.float32), [0, 2, 1])
        if pads != [0, 0]:
            x = tf.pad(x, [[0, 0], [pads[0], pads[1]], [0, 0]])
        y = tf.nn.conv1d(x, tf.transpose(tf.cast(w, tf.float32), [2, 1, 0]), stride=stride,
                         padding="VALID")
        if b is not None:
            y = y + tf.cast(b, tf.float32)
        return tf.transpose(tf.cast(y, dtype), [0, 2, 1])

    def normalize(x, axes, eps):
        """(x - mean) / sqrt(var + eps) over `axes`, spelled without
        `tf.nn.moments`: TF's CPU graph optimiser rewrites that pattern with
        variable scales into a fused layer norm that was 0.1 off the numpy
        evaluator on the tiny config's feature projection."""
        centred = x - tf.reduce_mean(x, axis=axes, keepdims=True)
        var = tf.reduce_mean(centred * centred, axis=axes, keepdims=True)
        return centred / tf.sqrt(var + eps)

    def instance_norm(a, x, scale, bias):
        y = normalize(x, [2], a.get("epsilon", 1e-5))
        return y * scale[None, :, None] + bias[None, :, None]

    def layer_norm(a, x, scale, bias=None):
        y = normalize(x, [len(x.shape) - 1], a.get("epsilon", 1e-5)) * scale
        return y if bias is None else y + bias

    def slice_(a, x, starts, ends, axes=None, steps=None):
        axes = range(len(starts)) if axes is None else axes
        steps = [1] * len(starts) if steps is None else steps
        index = [slice(None)] * len(x.shape)
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            en = None if int(en) >= (1 << 63) - 2 else int(en)
            index[int(ax)] = slice(int(st), en, int(sp))
        return x[tuple(index)]

    def div(a, x, y):
        if x.dtype.is_integer:  # ONNX's int64 Div truncates
            return tf.truncatediv(x, tf.cast(y, x.dtype))
        return x / y

    return {
        "Reshape": reshape,
        "Cast": lambda a, x: tf.cast(x, dtypes[a["to"]]),
        "Conv": conv,
        "InstanceNormalization": instance_norm,
        "LayerNormalization": layer_norm,
        "Transpose": lambda a, x: tf.transpose(x, a.get("perm")),
        "MatMul": lambda a, x, y: tf.matmul(x, y),
        "Add": lambda a, x, y: x + y,
        "Sub": lambda a, x, y: x - y,
        "Mul": lambda a, x, y: x * y,
        "Div": div,
        "Pow": lambda a, x, y: tf.pow(x, tf.cast(y, x.dtype)),
        "Erf": lambda a, x: tf.math.erf(x),
        "Tanh": lambda a, x: tf.math.tanh(x),
        "Softmax": lambda a, x: tf.nn.softmax(x, axis=a.get("axis", -1)),
        "Slice": slice_,
        "ReduceSum": lambda a, x, axes: tf.reduce_sum(
            x, axis=[int(v) for v in axes], keepdims=bool(a.get("keepdims", 1))),
        "Less": lambda a, x, y: tf.less(x, y),
        "Identity": lambda a, x: tf.identity(x),
    }


def export_saved_model(
    config: Wav2Vec2Config,
    params,
    save_dir: str,
    *,
    seqlen: int = 246000,
    with_lm_head: bool = True,
    with_attention_mask: Optional[bool] = None,
    compute_dtype: str = "float32",
) -> str:
    """Write a TF SavedModel with a fixed-`seqlen`, any-batch signature.
    `params` is the JAX-layout tree (`params_to_jax(model.state_dict())`);
    `compute_dtype` "float32" or "bfloat16"."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("the TF SavedModel export needs tensorflow, which is not "
                          "installed here") from e

    if with_attention_mask is None:
        with_attention_mask = config.is_robust
    graph = build_wav2vec2_onnx(
        config, params, seqlen=seqlen, with_lm_head=with_lm_head,
        with_attention_mask=with_attention_mask, compute_dtype=compute_dtype,
    )["graph"]
    ops = _tf_ops(tf)
    for node in graph["node"]:
        if node["op_type"] not in ops:
            raise NotImplementedError(f"op {node['op_type']!r} has no TF evaluation")
    consts, variables = {}, {}
    for t in graph["initializer"]:
        arr = P.array_from_tensor(t)
        if arr.dtype == np.float32 and arr.ndim >= 1:
            variables[t["name"]] = tf.Variable(
                arr, name=re.sub(r"[^A-Za-z0-9_.\-/]", "_", t["name"]))
        else:
            consts[t["name"]] = arr
    nodes = [(node["op_type"], _attrs(node), node.get("input", []), node["output"])
             for node in graph["node"]]
    out_name = graph["output"][0]["name"]

    def run(feeds: dict):
        env = {**consts, **variables, **feeds}
        for op, attrs, inputs, outputs in nodes:
            env[outputs[0]] = ops[op](attrs, *(env[n] if n else None for n in inputs))
        return env[out_name]

    module = tf.Module()
    module._params = list(variables.values())  # tracked by the SavedModel

    specs = [tf.TensorSpec([None, seqlen], tf.float32, name="speech")]
    if with_attention_mask:
        specs.append(tf.TensorSpec([None, seqlen], tf.float32, name="attention_mask"))

    @tf.function(input_signature=specs, autograph=False)
    def serving(speech, attention_mask=None):
        feeds = {"speech": speech}
        if with_attention_mask:
            feeds["attention_mask"] = attention_mask
        return run(feeds)

    module.__call__ = serving
    tf.saved_model.save(module, save_dir, signatures={"serving_default": serving})
    return save_dir
