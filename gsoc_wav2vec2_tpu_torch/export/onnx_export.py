"""Literal `.onnx` artifact export for Wav2Vec2ForCTC / Wav2Vec2Model.

The port's copy of `gsoc_wav2vec2_tpu/export/onnx_export.py`: the same
graph builder, fed the parameter tree in the JAX package's layout as numpy
(`convert/jax_bridge.py::params_to_jax` of the model's state dict), so that
for the same weights `model.onnx` is byte-equal to the JAX package's.  It
builds the inference graph directly — op by op, mirroring the eval-time
forward — and serializes it with the from-scratch protobuf codec
(`onnx_proto.py`), so it needs neither the `onnx` package nor tf2onnx.

Graph contract (opset 17, IR version 8):
  * input  `speech`: float32 (batch, seqlen) — symbolic batch dim, fixed
    seqlen (same contract as `export/torch_export.py`);
  * robust models additionally take `attention_mask`: float32
    (batch, seqlen), reproducing the sample->frame mask arithmetic of
    `modeling.py::wav2vec2_forward` (reference `modeling.py:201-206`) in
    int64 graph ops;
  * output `logits` (with the LM head) or `hidden_states`.

Eval-time semantics only: dropout/SpecAugment are inactive and stochastic
depth degenerates to a plain residual Add (reference
`tensorflow_addons.py:386-390` — no rescale at inference).  Weight-norm on
the positional conv folds into a static kernel at export time
(`ops/conv.py::weight_norm_kernel` recomputed in numpy float32).

Float32 semantics throughout: GELU uses the exact-erf form the float32
path uses (`ops/basic.py::gelu`); parity with the f32 forward is tested to
~1e-4 logits by executing the artifact with `export/onnx_numpy.py`.

`build_wav2vec2_onnx(compute_dtype="bfloat16")` builds the graph of the JAX
package's bf16 forward instead, for `export/savedmodel.py` (an `.onnx` file
is always float32): the waveform and every weight cast to bf16 at their
use, norms and the attention scores and softmax in f32 between casts, tanh
GELU, f32 logits.  For float32 the builder emits exactly the graph above.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from ..models.config import Wav2Vec2Config
from . import onnx_proto as P

ONNX_NAME = "model.onnx"
META_NAME = "export_meta.json"
OPSET_VERSION = 17
IR_VERSION = 8  # the IR release that introduced opset 17 support


# ---------------------------------------------------------------------------
# Graph builder
# ---------------------------------------------------------------------------


def _attr(name: str, v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"name": name, "i": int(v), "type": P.ATTR_INT}
    if isinstance(v, int):
        return {"name": name, "i": v, "type": P.ATTR_INT}
    if isinstance(v, float):
        return {"name": name, "f": v, "type": P.ATTR_FLOAT}
    if isinstance(v, str):
        return {"name": name, "s": v.encode("utf-8"), "type": P.ATTR_STRING}
    if isinstance(v, np.ndarray):
        return {"name": name, "t": P.tensor_from_array(v, name), "type": P.ATTR_TENSOR}
    if isinstance(v, (list, tuple)):
        if all(isinstance(x, int) for x in v):
            return {"name": name, "ints": list(v), "type": P.ATTR_INTS}
        if all(isinstance(x, (int, float)) for x in v):
            return {"name": name, "floats": [float(x) for x in v], "type": P.ATTR_FLOATS}
    raise TypeError(f"unsupported attribute {name}={v!r}")


class GraphBuilder:
    """Tiny ONNX graph assembler: initializers + topologically-ordered nodes."""

    def __init__(self, name: str, compute_dtype: str = "float32"):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
        self.name = name
        self.bf16 = compute_dtype == "bfloat16"
        self.nodes: List[dict] = []
        self.initializers: List[dict] = []
        self.inputs: List[dict] = []
        self.outputs: List[dict] = []
        self._counter = 0
        self._const_cache: Dict[tuple, str] = {}

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}.{self._counter}"

    def init(self, arr: np.ndarray, hint: str) -> str:
        name = self.fresh(hint)
        self.initializers.append(P.tensor_from_array(np.asarray(arr), name))
        return name

    def const(self, value, dtype, hint: str = "const") -> str:
        """Cached scalar/1-D constant initializer."""
        arr = np.asarray(value, dtype=dtype)
        key = (arr.dtype.name, arr.shape, arr.tobytes())
        if key not in self._const_cache:
            self._const_cache[key] = self.init(arr, hint)
        return self._const_cache[key]

    def weight(self, arr: np.ndarray, hint: str) -> str:
        """A parameter initializer (float32) in the compute dtype: a bf16
        graph casts it at its use, as the JAX forward casts each weight."""
        name = self.init(arr, hint)
        return self.to_compute(name, hint)

    def to_compute(self, x: str, hint: str) -> str:
        """`x` (float32) in the compute dtype."""
        return self.node("Cast", [x], hint=f"{hint}.bf16", to=P.BFLOAT16) if self.bf16 else x

    def scalar(self, value: float) -> str:
        """A float constant in the compute dtype."""
        name = self.const(value, np.float32)
        if not self.bf16:
            return name
        key = ("bf16", name)
        if key not in self._const_cache:
            self._const_cache[key] = self.to_compute(name, "const")
        return self._const_cache[key]

    def in_f32(self, x: str, op, hint: str) -> str:
        """`op(x)` computed in float32: a bf16 graph casts `x` up and the
        result back (the JAX forward's norms)."""
        if not self.bf16:
            return op(x)
        y = op(self.node("Cast", [x], hint=f"{hint}.f32", to=P.FLOAT))
        return self.to_compute(y, hint)

    def node(
        self,
        op_type: str,
        inputs: Sequence[str],
        n_out: int = 1,
        hint: Optional[str] = None,
        **attrs,
    ) -> Union[str, tuple]:
        hint = hint or op_type.lower()
        outputs = [self.fresh(hint) for _ in range(n_out)]
        node = {
            "op_type": op_type,
            "input": list(inputs),
            "output": outputs,
            "name": self.fresh(f"n.{op_type}"),
        }
        if attrs:
            node["attribute"] = [_attr(k, v) for k, v in attrs.items()]
        self.nodes.append(node)
        return outputs[0] if n_out == 1 else tuple(outputs)

    @staticmethod
    def _value_info(name: str, elem_type: int, shape) -> dict:
        dims = []
        for d in shape:
            dims.append({"dim_param": d} if isinstance(d, str) else {"dim_value": int(d)})
        return {
            "name": name,
            "type": {"tensor_type": {"elem_type": elem_type, "shape": {"dim": dims}}},
        }

    def add_input(self, name: str, elem_type: int, shape) -> str:
        self.inputs.append(self._value_info(name, elem_type, shape))
        return name

    def add_output(self, name: str, elem_type: int, shape) -> None:
        self.outputs.append(self._value_info(name, elem_type, shape))

    def model(self, *, doc: str = "", metadata: Optional[Dict[str, str]] = None) -> dict:
        return {
            "ir_version": IR_VERSION,
            "producer_name": "gsoc_wav2vec2_tpu",
            "producer_version": "1.0",
            "opset_import": [{"domain": "", "version": OPSET_VERSION}],
            "doc_string": doc,
            "graph": {
                "name": self.name,
                "node": self.nodes,
                "initializer": self.initializers,
                "input": self.inputs,
                "output": self.outputs,
            },
            "metadata_props": [
                {"key": k, "value": v} for k, v in (metadata or {}).items()
            ],
        }


# ---------------------------------------------------------------------------
# Wav2Vec2 emission (mirrors models/modeling.py eval-time forward)
# ---------------------------------------------------------------------------


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # `params_to_jax` keeps bf16 leaves as tensors
        x = x.detach().cpu().float().numpy()
    return np.asarray(x).astype(np.float32)


def _layer_slice(tree, i: int):
    """Layer `i` of the stacked encoder-layer tree (each leaf's row `i`)."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _dense(b: GraphBuilder, x: str, p: dict, hint: str) -> str:
    y = b.node("MatMul", [x, b.weight(_np32(p["kernel"]), f"{hint}.kernel")], hint=hint)
    if p.get("bias") is not None:
        y = b.node("Add", [y, b.weight(_np32(p["bias"]), f"{hint}.bias")], hint=hint)
    return y


def _layer_norm(b: GraphBuilder, x: str, p: dict, eps: float, hint: str) -> str:
    return b.in_f32(x, lambda x32: b.node(
        "LayerNormalization",
        [x32, b.init(_np32(p["gamma"]), f"{hint}.gamma"),
         b.init(_np32(p["beta"]), f"{hint}.beta")],
        hint=hint,
        axis=-1,
        epsilon=float(eps),
    ), hint)


def _gelu(b: GraphBuilder, x: str, approximate: bool, hint: str) -> str:
    """GELU via primitive ops (the fused Gelu op is opset 20; we target 17).

    Exact: 0.5 * x * (1 + erf(x / sqrt(2))) — matches the float32 JAX path.
    Approximate: the tanh form (`jax.nn.gelu(approximate=True)`), which a
    bf16 graph always takes (`ops/basic.py::gelu`).
    """
    f = b.scalar
    if approximate or b.bf16:
        x3 = b.node("Pow", [x, f(3.0)], hint=hint)
        inner = b.node("Add", [x, b.node("Mul", [x3, f(0.044715)], hint=hint)], hint=hint)
        t = b.node("Tanh", [b.node("Mul", [inner, f(float(np.sqrt(2.0 / np.pi)))], hint=hint)], hint=hint)
        one_plus = b.node("Add", [t, f(1.0)], hint=hint)
    else:
        erf = b.node("Erf", [b.node("Div", [x, f(float(np.sqrt(2.0)))], hint=hint)], hint=hint)
        one_plus = b.node("Add", [erf, f(1.0)], hint=hint)
    half_x = b.node("Mul", [x, f(0.5)], hint=hint)
    return b.node("Mul", [half_x, one_plus], hint=hint)


def _conv_ncl(
    b: GraphBuilder,
    x: str,
    kernel: np.ndarray,  # ours: (k, C_in // groups, C_out)
    bias: Optional[np.ndarray],
    *,
    stride: int,
    groups: int = 1,
    pads: tuple = (0, 0),
    hint: str,
) -> str:
    w = np.transpose(kernel, (2, 1, 0))  # -> ONNX (C_out, C_in // groups, k)
    inputs = [x, b.weight(w, f"{hint}.weight")]
    if bias is not None:
        inputs.append(b.weight(bias, f"{hint}.bias"))
    return b.node(
        "Conv",
        inputs,
        hint=hint,
        strides=[stride],
        group=groups,
        pads=list(pads),
        kernel_shape=[w.shape[-1]],
    )


def _feature_encoder(b: GraphBuilder, x_ncl: str, params, config: Wav2Vec2Config) -> str:
    """7x strided conv stack in NCL layout (`modeling.py::feature_encoder_forward`)."""
    for i, p in enumerate(params["conv_layers"]):
        hint = f"fe.conv{i}"
        x_ncl = _conv_ncl(
            b, x_ncl, _np32(p["conv"]["kernel"]),
            _np32(p["conv"]["bias"]) if p["conv"].get("bias") is not None else None,
            stride=config.strides[i], hint=hint,
        )
        if "layer_norm" in p:
            if config.feature_extractor_norm_type == "group":
                # groups == channels (the wav2vec2 contract): GroupNorm
                # degenerates to per-channel instance norm over time — the
                # exact InstanceNormalization op (`ops/basic.py::group_norm`)
                assert config.filter_sizes[i] == _np32(p["layer_norm"]["gamma"]).shape[0]
                x_ncl = b.in_f32(x_ncl, lambda x32: b.node(
                    "InstanceNormalization",
                    [x32,
                     b.init(_np32(p["layer_norm"]["gamma"]), f"{hint}.gn.gamma"),
                     b.init(_np32(p["layer_norm"]["beta"]), f"{hint}.gn.beta")],
                    hint=f"{hint}.gn",
                    epsilon=1e-5,
                ), f"{hint}.gn")
            else:  # robust family: LayerNorm over channels
                x_btc = b.node("Transpose", [x_ncl], hint=hint, perm=[0, 2, 1])
                x_btc = _layer_norm(b, x_btc, p["layer_norm"], 1e-5, f"{hint}.ln")
                x_ncl = b.node("Transpose", [x_btc], hint=hint, perm=[0, 2, 1])
        x_ncl = _gelu(b, x_ncl, config.is_gelu_approx, f"{hint}.gelu")
    return x_ncl


def _frame_mask(b: GraphBuilder, mask: str, config: Wav2Vec2Config, frames: int):
    """Sample-level mask -> (frame_mask_f32 (B, T'), attention bias (B,1,1,T')).

    Reference `modeling.py:201-206` / our `wav2vec2_forward`: frame count is
    the conv length arithmetic `1 + (len - kernel) // stride` per layer —
    int64 Div truncation equals floor for the non-negative lengths here.
    """
    i64 = lambda v: b.const(v, np.int64)  # noqa: E731
    mask_i = b.node("Cast", [mask], hint="mask.int", to=P.INT64)
    lens = b.node(
        "ReduceSum", [mask_i, b.init(np.array([1], np.int64), "mask.axes")],
        hint="mask.len", keepdims=1,
    )  # (B, 1)
    for k, s in zip(config.kernal_sizes, config.strides):
        lens = b.node("Sub", [lens, i64(k)], hint="mask.len")
        lens = b.node("Div", [lens, i64(s)], hint="mask.len")
        lens = b.node("Add", [lens, i64(1)], hint="mask.len")
    arange = b.init(np.arange(frames, dtype=np.int64)[None, :], "mask.arange")
    frame_bool = b.node("Less", [arange, lens], hint="mask.frame")  # (B, T')
    frame_f = b.node("Cast", [frame_bool], hint="mask.framef", to=P.FLOAT)
    inv = b.node("Sub", [b.const(1.0, np.float32), frame_f], hint="mask.inv")
    bias = b.node("Mul", [inv, b.const(-10000.0, np.float32)], hint="mask.bias")
    bias = b.node(
        "Reshape", [bias, b.init(np.array([0, 1, 1, frames], np.int64), "mask.bshape")],
        hint="mask.bias4d",
    )
    return frame_f, bias


def _attention(
    b: GraphBuilder, x: str, p: dict, config: Wav2Vec2Config, frames: int,
    bias: Optional[str], hint: str,
) -> str:
    """`ops/attention.py::mha_xla` at eval time (no dropout)."""
    h, n = config.hidden_size, config.num_heads
    d = h // n
    shape_heads = b.init(np.array([0, frames, n, d], np.int64), f"{hint}.hshape")
    shape_merge = b.init(np.array([0, frames, h], np.int64), f"{hint}.mshape")

    def heads(t: str, tag: str) -> str:
        t = b.node("Reshape", [t, shape_heads], hint=f"{hint}.{tag}")
        return b.node("Transpose", [t], hint=f"{hint}.{tag}", perm=[0, 2, 1, 3])

    q = _dense(b, x, p["q_proj"], f"{hint}.q")
    q = b.node("Mul", [q, b.scalar(float(d) ** -0.5)], hint=f"{hint}.qs")
    k = _dense(b, x, p["k_proj"], f"{hint}.k")
    v = _dense(b, x, p["v_proj"], f"{hint}.v")
    qh, kh, vh = heads(q, "qh"), heads(k, "kh"), heads(v, "vh")
    kt = b.node("Transpose", [kh], hint=f"{hint}.kt", perm=[0, 1, 3, 2])
    if b.bf16:  # scores and softmax in f32 (the JAX product's preferred type)
        qh = b.node("Cast", [qh], hint=f"{hint}.qh.f32", to=P.FLOAT)
        kt = b.node("Cast", [kt], hint=f"{hint}.kt.f32", to=P.FLOAT)
    scores = b.node("MatMul", [qh, kt], hint=f"{hint}.scores")
    if bias is not None:
        scores = b.node("Add", [scores, bias], hint=f"{hint}.scores")
    probs = b.node("Softmax", [scores], hint=f"{hint}.probs", axis=-1)
    probs = b.to_compute(probs, f"{hint}.probs")
    ctx = b.node("MatMul", [probs, vh], hint=f"{hint}.ctx")
    ctx = b.node("Transpose", [ctx], hint=f"{hint}.ctx", perm=[0, 2, 1, 3])
    ctx = b.node("Reshape", [ctx, shape_merge], hint=f"{hint}.ctx")
    return _dense(b, ctx, p["out_proj"], f"{hint}.out")


def _transformer_layer(
    b: GraphBuilder, x: str, p: dict, config: Wav2Vec2Config, frames: int,
    bias: Optional[str], hint: str,
) -> str:
    """`modeling.py::transformer_layer_forward`, eval semantics (stochastic
    depth == plain residual Add; reference `tensorflow_addons.py:386-390`)."""
    prenorm = config.attention_norm_type == "prenorm"
    residual = x
    if prenorm:
        x = _layer_norm(b, x, p["layer_norm"], config.layer_norm_eps, f"{hint}.ln1")
    x = _attention(b, x, p["attention"], config, frames, bias, f"{hint}.attn")
    x = b.node("Add", [x, residual], hint=f"{hint}.res1")
    if not prenorm:
        x = _layer_norm(b, x, p["layer_norm"], config.layer_norm_eps, f"{hint}.ln1")

    residual = x
    if prenorm:
        x = _layer_norm(b, x, p["final_layer_norm"], config.layer_norm_eps, f"{hint}.ln2")
    x = _dense(b, x, p["feed_forward"]["intermediate_dense"], f"{hint}.ff1")
    x = _gelu(b, x, config.is_gelu_approx, f"{hint}.ffgelu")
    x = _dense(b, x, p["feed_forward"]["output_dense"], f"{hint}.ff2")
    x = b.node("Add", [residual, x], hint=f"{hint}.res2")
    if not prenorm:
        x = _layer_norm(b, x, p["final_layer_norm"], config.layer_norm_eps, f"{hint}.ln2")
    return x


def _pos_conv(b: GraphBuilder, x: str, p: dict, config: Wav2Vec2Config, frames: int) -> str:
    """`ops/conv.py::pos_conv_embed`: weight-norm folded at export time."""
    v32 = _np32(p["weight_v"])
    norm = np.sqrt(np.sum(np.square(v32), axis=(1, 2), keepdims=True))
    kernel = (v32 / norm * _np32(p["weight_g"])).astype(np.float32)
    ksz = config.num_conv_pos_embeddings
    pad = ksz // 2
    x_ncl = b.node("Transpose", [x], hint="pos.ncl", perm=[0, 2, 1])
    y = _conv_ncl(
        b, x_ncl, kernel, _np32(p["bias"]) if p.get("bias") is not None else None,
        stride=1, groups=config.num_conv_pos_embedding_groups,
        pads=(pad, pad), hint="pos.conv",
    )
    y = b.node("Transpose", [y], hint="pos.btc", perm=[0, 2, 1])
    if ksz % 2 == 0:  # even-kernel crop (reference `encoder.py:175-180`)
        y = b.node(
            "Slice",
            [y,
             b.init(np.array([0], np.int64), "pos.start"),
             b.init(np.array([frames], np.int64), "pos.end"),
             b.init(np.array([1], np.int64), "pos.axis")],
            hint="pos.crop",
        )
    return _gelu(b, y, config.is_gelu_approx, "pos.gelu")


def build_wav2vec2_onnx(
    config: Wav2Vec2Config,
    params,
    *,
    seqlen: int = 246000,
    with_lm_head: bool = True,
    with_attention_mask: Optional[bool] = None,
    compute_dtype: str = "float32",
) -> dict:
    """Assemble the full inference graph; returns a ModelProto dict.
    `params` is the JAX-layout tree (`params_to_jax(model.state_dict())`);
    `compute_dtype` "bfloat16" gives the bf16 forward's graph (see above)."""
    if with_attention_mask is None:
        with_attention_mask = config.is_robust
    frames = int(config.conv_output_length(seqlen))
    b = GraphBuilder("wav2vec2_for_ctc" if with_lm_head else "wav2vec2", compute_dtype)

    speech = b.add_input("speech", P.FLOAT, ["batch", seqlen])
    mask_in = (
        b.add_input("attention_mask", P.FLOAT, ["batch", seqlen])
        if with_attention_mask
        else None
    )

    w2v = params["wav2vec2"] if with_lm_head else params

    x = b.node(
        "Reshape", [speech, b.init(np.array([0, 1, seqlen], np.int64), "in.shape")],
        hint="in.ncl",
    )
    x = b.to_compute(x, "in.ncl")
    x = _feature_encoder(b, x, w2v["feature_extractor"], config)
    x = b.node("Transpose", [x], hint="fe.btc", perm=[0, 2, 1])  # (B, T', C)

    fp = w2v["feature_projection"]
    if config.feat_proj_layer_norm:
        x = _layer_norm(b, x, fp["layer_norm"], config.layer_norm_eps, "fp.ln")
    x = _dense(b, x, fp["projection"], "fp.proj")

    bias = None
    if mask_in is not None:
        frame_f, bias = _frame_mask(b, mask_in, config, frames)
        frame_3d = b.node(
            "Reshape",
            [frame_f, b.init(np.array([0, frames, 1], np.int64), "mask.xshape")],
            hint="mask.3d",
        )
        x = b.node("Mul", [x, b.to_compute(frame_3d, "mask.3d")], hint="mask.zero")

    enc = w2v["encoder"]
    x = b.node("Add", [x, _pos_conv(b, x, enc["pos_conv_embed"]["conv"], config, frames)],
               hint="pos.add")
    prenorm = config.attention_norm_type == "prenorm"
    if not prenorm:
        x = _layer_norm(b, x, enc["layer_norm"], config.layer_norm_eps, "enc.ln")

    for i in range(config.num_layers):
        layer_p = _layer_slice(enc["layers"], i)
        x = _transformer_layer(b, x, layer_p, config, frames, bias, f"enc.l{i}")

    if prenorm:
        x = _layer_norm(b, x, enc["layer_norm"], config.layer_norm_eps, "enc.ln")

    out_type = P.FLOAT
    if with_lm_head:
        x = _dense(b, x, params["lm_head"], "lm_head")
        if b.bf16:  # f32 logits, as the JAX forward returns them
            x = b.node("Cast", [x], hint="lm_head.f32", to=P.FLOAT)
        out_name, out_dim = "logits", config.vocab_size
    else:
        out_name, out_dim = "hidden_states", config.hidden_size
        out_type = P.BFLOAT16 if b.bf16 else P.FLOAT

    # final Identity pins the public output name
    b.nodes.append({"op_type": "Identity", "input": [x], "output": [out_name],
                    "name": b.fresh("n.Identity")})
    b.add_output(out_name, out_type, ["batch", frames, out_dim])
    return b.model(
        doc=(
            "wav2vec2 CTC inference graph exported by gsoc_wav2vec2_tpu "
            f"(seqlen={seqlen}, frames={frames})"
        ),
        metadata={
            "seqlen": str(seqlen),
            "frames": str(frames),
            "with_lm_head": str(with_lm_head),
            "with_attention_mask": str(with_attention_mask),
        },
    )


def export_onnx(
    config: Wav2Vec2Config,
    params,
    save_dir: str,
    *,
    seqlen: int = 246000,
    with_lm_head: bool = True,
    with_attention_mask: Optional[bool] = None,
) -> str:
    """Write `<save_dir>/model.onnx` (+ meta + config.json); returns the path."""
    model = build_wav2vec2_onnx(
        config, params, seqlen=seqlen, with_lm_head=with_lm_head,
        with_attention_mask=with_attention_mask,
    )
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, ONNX_NAME)
    with open(path, "wb") as f:
        f.write(P.encode_model(model))
    with open(os.path.join(save_dir, META_NAME), "w") as f:
        json.dump(
            {
                "format": "onnx",
                "opset": OPSET_VERSION,
                "seqlen": seqlen,
                "with_lm_head": with_lm_head,
                "with_attention_mask": (
                    config.is_robust if with_attention_mask is None
                    else with_attention_mask
                ),
                "vocab_size": config.vocab_size,
            },
            f,
        )
    config.save_pretrained(save_dir)
    return path
