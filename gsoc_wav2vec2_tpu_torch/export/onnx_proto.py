"""From-scratch ONNX protobuf codec (the `onnx` package is not needed).

The port's copy of `gsoc_wav2vec2_tpu/export/onnx_proto.py` (numpy only;
the port imports nothing of the JAX package), byte for byte the same codec.

ONNX's serialization format is an ordinary protobuf: a `ModelProto` per the
public `onnx/onnx.proto` schema.  This module implements the protobuf wire
format (encode + decode) and the subset of the ONNX message schema the
exporter needs — enough to write a standards-conformant `.onnx` file and to
read one back (including files produced by other writers, e.g. torch's
C++ exporter; unknown fields are skipped per the protobuf spec).

Validation (tests/test_torch_onnx.py):
  * the emitted bytes parse field-for-field under bindings protoc compiles
    from the schema text beside this file (`onnx_subset.proto`);
  * the port's artifact is byte-equal to the JAX package's for the same
    weights;
  * `export/onnx_numpy.py` executes the graph and matches the forward.

Wire format notes:
  * varint fields encode two's-complement int64 as 10-byte varints when
    negative (proto2/proto3 rule);
  * repeated scalars are written packed (wire type 2) — conformant proto2
    parsers accept packed and unpacked interchangeably, and the decoder
    here likewise accepts both.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union


class Field(NamedTuple):
    """One schema field: number, type, repeated flag.

    `ftype` is a scalar type name ("int64", "int32", "uint64", "float",
    "double", "string", "bytes") or a dict (a nested message schema).
    Message schemas are plain dicts `{field_name: Field}` so recursive
    references can be patched in after construction.
    """

    num: int
    ftype: Union[str, dict]
    repeated: bool = False


_VARINT_TYPES = ("int64", "int32", "uint64", "bool")


# ---------------------------------------------------------------------------
# Wire primitives
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's complement, 10 bytes
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(num: int, wire_type: int) -> bytes:
    out = bytearray()
    _write_varint(out, (num << 3) | wire_type)
    return bytes(out)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _encode_scalar(out: bytearray, ftype: str, value: Any) -> None:
    """Scalar payload only (no tag) — used inside packed runs."""
    if ftype in _VARINT_TYPES:
        _write_varint(out, int(value))
    elif ftype == "float":
        out += struct.pack("<f", float(value))
    elif ftype == "double":
        out += struct.pack("<d", float(value))
    else:  # pragma: no cover - schema bug
        raise TypeError(f"not a packable scalar: {ftype}")


def encode_message(schema: Dict[str, Field], msg: Dict[str, Any]) -> bytes:
    """Encode a plain-dict message per `schema`; fields in ascending number
    order (canonical-ish, matches what protobuf runtimes emit)."""
    out = bytearray()
    for name, f in sorted(schema.items(), key=lambda kv: kv[1].num):
        if name not in msg or msg[name] is None:
            continue
        value = msg[name]
        values = value if f.repeated else [value]
        if isinstance(f.ftype, dict):
            for v in values:
                body = encode_message(f.ftype, v)
                out += _tag(f.num, 2)
                _write_varint(out, len(body))
                out += body
        elif f.ftype in ("string", "bytes"):
            for v in values:
                data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                out += _tag(f.num, 2)
                _write_varint(out, len(data))
                out += data
        elif f.repeated:
            # packed run (valid proto2/proto3; parsers accept either form)
            if not values:
                continue
            body = bytearray()
            for v in values:
                _encode_scalar(body, f.ftype, v)
            out += _tag(f.num, 2)
            _write_varint(out, len(body))
            out += body
        elif f.ftype in _VARINT_TYPES:
            out += _tag(f.num, 0)
            _write_varint(out, int(value))
        elif f.ftype == "float":
            out += _tag(f.num, 5)
            out += struct.pack("<f", float(value))
        elif f.ftype == "double":
            out += _tag(f.num, 1)
            out += struct.pack("<d", float(value))
        else:  # pragma: no cover - schema bug
            raise TypeError(f"unknown field type {f.ftype}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _coerce_varint(ftype: str, raw: int) -> Any:
    if ftype == "int64":
        return _signed64(raw)
    if ftype == "int32":
        v = _signed64(raw)
        # int32 fields are sign-extended to 64 bits on the wire
        return v - (1 << 32) if v >= (1 << 31) else v
    if ftype == "bool":
        return bool(raw)
    return raw  # uint64


def decode_message(schema: Dict[str, Field], data: bytes) -> Dict[str, Any]:
    """Decode bytes into a plain dict per `schema`.

    Unknown field numbers are skipped by wire type (forward-compatible —
    lets this reader consume full ONNX files that use fields outside the
    subset).  Repeated scalars accept packed and unpacked encodings.
    """
    by_num = {f.num: (name, f) for name, f in schema.items()}
    msg: Dict[str, Any] = {}
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        num, wt = key >> 3, key & 7
        entry = by_num.get(num)
        if entry is None:  # skip unknown
            if wt == 0:
                _, pos = _read_varint(data, pos)
            elif wt == 1:
                pos += 8
            elif wt == 2:
                ln, pos = _read_varint(data, pos)
                pos += ln
            elif wt == 5:
                pos += 4
            else:
                raise ValueError(f"unsupported wire type {wt}")
            continue
        name, f = entry
        if isinstance(f.ftype, dict) or f.ftype in ("string", "bytes"):
            if wt != 2:
                raise ValueError(f"field {name}: expected length-delimited")
            ln, pos = _read_varint(data, pos)
            chunk = data[pos : pos + ln]
            pos += ln
            if isinstance(f.ftype, dict):
                value: Any = decode_message(f.ftype, chunk)
            elif f.ftype == "string":
                value = chunk.decode("utf-8")
            else:
                value = bytes(chunk)
            _store(msg, name, f, value)
        elif wt == 2:  # packed scalars
            ln, pos = _read_varint(data, pos)
            stop = pos + ln
            while pos < stop:
                if f.ftype in _VARINT_TYPES:
                    raw, pos = _read_varint(data, pos)
                    v = _coerce_varint(f.ftype, raw)
                elif f.ftype == "float":
                    (v,) = struct.unpack_from("<f", data, pos)
                    pos += 4
                else:  # double
                    (v,) = struct.unpack_from("<d", data, pos)
                    pos += 8
                _store(msg, name, f, v)
        elif wt == 0:
            raw, pos = _read_varint(data, pos)
            _store(msg, name, f, _coerce_varint(f.ftype, raw))
        elif wt == 5:
            (v,) = struct.unpack_from("<f", data, pos)
            pos += 4
            _store(msg, name, f, v)
        elif wt == 1:
            (v,) = struct.unpack_from("<d", data, pos)
            pos += 8
            _store(msg, name, f, v)
        else:
            raise ValueError(f"unsupported wire type {wt} for {name}")
    return msg


def _store(msg: dict, name: str, f: Field, value: Any) -> None:
    if f.repeated:
        msg.setdefault(name, []).append(value)
    else:
        msg[name] = value


# ---------------------------------------------------------------------------
# ONNX schema subset (official field numbers; onnx/onnx.proto)
# ---------------------------------------------------------------------------

# TensorProto.DataType
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = range(1, 10)
FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
BFLOAT16 = 16

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8

DIMENSION = {
    "dim_value": Field(1, "int64"),
    "dim_param": Field(2, "string"),
}
TENSOR_SHAPE = {"dim": Field(1, DIMENSION, repeated=True)}
TYPE_TENSOR = {
    "elem_type": Field(1, "int32"),
    "shape": Field(2, TENSOR_SHAPE),
}
TYPE = {"tensor_type": Field(1, TYPE_TENSOR)}
VALUE_INFO = {
    "name": Field(1, "string"),
    "type": Field(2, TYPE),
    "doc_string": Field(3, "string"),
}
TENSOR = {
    "dims": Field(1, "int64", repeated=True),
    "data_type": Field(2, "int32"),
    "float_data": Field(4, "float", repeated=True),
    "int32_data": Field(5, "int32", repeated=True),
    "string_data": Field(6, "bytes", repeated=True),
    "int64_data": Field(7, "int64", repeated=True),
    "name": Field(8, "string"),
    "raw_data": Field(9, "bytes"),
    "double_data": Field(10, "double", repeated=True),
    "uint64_data": Field(11, "uint64", repeated=True),
    "doc_string": Field(12, "string"),
}
ATTRIBUTE: Dict[str, Field] = {
    "name": Field(1, "string"),
    "f": Field(2, "float"),
    "i": Field(3, "int64"),
    "s": Field(4, "bytes"),
    "t": Field(5, TENSOR),
    # "g" (6) patched below — AttributeProto <-> GraphProto recursion
    "floats": Field(7, "float", repeated=True),
    "ints": Field(8, "int64", repeated=True),
    "strings": Field(9, "bytes", repeated=True),
    "doc_string": Field(13, "string"),
    "type": Field(20, "int32"),
}
NODE = {
    "input": Field(1, "string", repeated=True),
    "output": Field(2, "string", repeated=True),
    "name": Field(3, "string"),
    "op_type": Field(4, "string"),
    "attribute": Field(5, ATTRIBUTE, repeated=True),
    "doc_string": Field(6, "string"),
    "domain": Field(7, "string"),
}
GRAPH = {
    "node": Field(1, NODE, repeated=True),
    "name": Field(2, "string"),
    "initializer": Field(5, TENSOR, repeated=True),
    "doc_string": Field(10, "string"),
    "input": Field(11, VALUE_INFO, repeated=True),
    "output": Field(12, VALUE_INFO, repeated=True),
    "value_info": Field(13, VALUE_INFO, repeated=True),
}
ATTRIBUTE["g"] = Field(6, GRAPH)  # recursive: If/Loop subgraphs (read side)
OPERATOR_SET_ID = {
    "domain": Field(1, "string"),
    "version": Field(2, "int64"),
}
STRING_STRING_ENTRY = {
    "key": Field(1, "string"),
    "value": Field(2, "string"),
}
MODEL = {
    "ir_version": Field(1, "int64"),
    "producer_name": Field(2, "string"),
    "producer_version": Field(3, "string"),
    "domain": Field(4, "string"),
    "model_version": Field(5, "int64"),
    "doc_string": Field(6, "string"),
    "graph": Field(7, GRAPH),
    "opset_import": Field(8, OPERATOR_SET_ID, repeated=True),
    "metadata_props": Field(14, STRING_STRING_ENTRY, repeated=True),
}


def encode_model(model: Dict[str, Any]) -> bytes:
    return encode_message(MODEL, model)


def decode_model(data: bytes) -> Dict[str, Any]:
    return decode_message(MODEL, data)


# ---------------------------------------------------------------------------
# Tensor <-> numpy
# ---------------------------------------------------------------------------

_NP_TO_ONNX = {
    "float32": FLOAT,
    "float64": DOUBLE,
    "int64": INT64,
    "int32": INT32,
    "bool": BOOL,
    "uint8": UINT8,
    "int8": INT8,
    "float16": FLOAT16,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


def tensor_from_array(arr, name: str) -> Dict[str, Any]:
    """numpy array -> TensorProto dict (raw_data, little-endian)."""
    import numpy as np

    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_ONNX.get(arr.dtype.name)
    if dt is None:
        raise TypeError(f"unsupported dtype {arr.dtype} for ONNX tensor")
    le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return {
        "name": name,
        "dims": list(arr.shape),
        "data_type": dt,
        "raw_data": le.tobytes(),
    }


def array_from_tensor(t: Dict[str, Any]):
    """TensorProto dict -> numpy array (raw_data or typed repeated data)."""
    import numpy as np

    dt = t.get("data_type")
    np_dtype = _ONNX_TO_NP.get(dt)
    if np_dtype is None:
        raise TypeError(f"unsupported ONNX data_type {dt}")
    dims = tuple(t.get("dims", []))
    raw: Optional[bytes] = t.get("raw_data")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"))
        return arr.reshape(dims).astype(np_dtype)
    if dt == FLOAT:
        data = t.get("float_data", [])
    elif dt == DOUBLE:
        data = t.get("double_data", [])
    elif dt in (INT32, BOOL, UINT8, INT8, FLOAT16):
        data = t.get("int32_data", [])
    elif dt == INT64:
        data = t.get("int64_data", [])
    else:  # pragma: no cover
        raise TypeError(f"no typed-data field handler for data_type {dt}")
    return np.asarray(data, dtype=np_dtype).reshape(dims)
