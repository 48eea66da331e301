"""Reader of `model.safetensors` files, with numpy only.

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor name to {"dtype", "shape", "data_offsets": [begin,
end]} (offsets into the buffer after the header; an optional
"__metadata__" entry of strings), then the raw little-endian buffer.  The
card's machine has no `safetensors` package; this module reads the format
itself.  BF16 tensors are read as int16 and viewed as `torch.bfloat16`.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
# a header larger than this is not a safetensors header (the format's own cap)
MAX_HEADER = 100 * 1024 * 1024


def load(data: bytes) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors buffer, by name (CPU tensors)."""
    if len(data) < 8:
        raise ValueError("not a safetensors file: shorter than its header length")
    (n,) = struct.unpack("<Q", data[:8])
    if n > min(MAX_HEADER, len(data) - 8):
        raise ValueError(f"safetensors header length {n} exceeds the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    buf = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        dtype = info["dtype"]
        if not 0 <= begin <= end <= len(buf):
            raise ValueError(f"{name}: data offsets {begin}..{end} outside the buffer")
        raw = buf[begin:end]
        if dtype == "BF16":
            np_dtype = np.dtype("<i2")
        elif dtype in _DTYPES:
            np_dtype = np.dtype(_DTYPES[dtype]).newbyteorder("<")
        else:
            raise ValueError(f"{name}: unsupported safetensors dtype {dtype}")
        if len(raw) != int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize:
            raise ValueError(f"{name}: {len(raw)} bytes do not hold {dtype} {list(shape)}")
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape).astype(np_dtype.newbyteorder("="))
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    return out


def load_file(path: str) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        return load(f.read())
