"""Reader and writer of the msgpack that `flax.serialization` writes.

`jax_model.msgpack` (the JAX package's `save_pretrained`) is
`flax.serialization.to_bytes(params)`: msgpack of the parameter tree, with
tuples written as maps keyed "0", "1", ... and every array an extension
object.  The card's machine has neither flax nor the `msgpack` package, so
this module speaks the subset of msgpack that flax writes, with numpy only:

  * maps with str keys, arrays, str, bin, int, float, bool and nil;
  * ext 1 `ndarray`: its payload is itself msgpack, the triple
    (shape, dtype name, raw C-order bytes);
  * ext 3 `npscalar`: the same payload holding a 0-d array;
  * dtype name "bfloat16" (which numpy lacks): read as uint16 and viewed as
    `torch.bfloat16`; such leaves come back as torch tensors;
  * flax's `__msgpack_chunked_array__` maps, which flax writes for arrays of
    more than `MAX_CHUNK_SIZE` bytes: read by concatenating the chunks.

`packb` writes the same encodings the `msgpack` package picks (the shortest
form of each int, str, bin, map, array and ext header; floats as float64),
so a tree of numpy arrays packs to the bytes `flax.serialization.to_bytes`
gives it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

NDARRAY_EXT = 1
NPSCALAR_EXT = 3
MAX_CHUNK_SIZE = 2**30
CHUNKED_KEY = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Malformed or unsupported msgpack data."""


# -- decoding ---------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated msgpack: need {n} bytes at offset {self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, ext_hook) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, ext_hook)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, ext_hook)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(n, ext_hook)
            if kind == "str":
                return self.str(n)
            return self.array(n, ext_hook) if kind == "array" else self.map(n, ext_hook)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4), ext_hook)
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int, ext_hook) -> list:
        return [self.value(ext_hook) for _ in range(n)]

    def map(self, n: int, ext_hook) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(ext_hook)
            out[key] = self.value(ext_hook)
        return out

    def ext(self, n: int, ext_hook):
        code = self.unpack(">b")
        return ext_hook(code, bytes(self.take(n)))


def _no_ext(code: int, data: bytes):
    raise MsgpackError(f"unexpected msgpack ext type {code} inside an array payload")


def unpackb(data: bytes, ext_hook=_no_ext) -> Any:
    """Decode one msgpack object; `ext_hook(code, payload)` decodes ext objects."""
    reader = _Reader(data)
    out = reader.value(ext_hook)
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"{len(reader.buf) - reader.pos} trailing bytes after the msgpack object")
    return out


def _array_from_payload(payload: bytes):
    """(shape, dtype name, raw bytes) -> numpy array, or a torch bf16 tensor."""
    triple = unpackb(payload)
    if not (isinstance(triple, list) and len(triple) == 3):
        raise MsgpackError("an ndarray payload must be (shape, dtype, bytes)")
    shape, name, raw = triple
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<i2").reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"unsupported array dtype {name!r}") from e
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _flax_ext(code: int, data: bytes):
    if code == NDARRAY_EXT:
        return _array_from_payload(data)
    if code == NPSCALAR_EXT:
        arr = _array_from_payload(data)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    raise MsgpackError(f"unsupported msgpack ext type {code} (flax writes 1 and 3)")


def _concat(chunks):
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks])
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks])


def _unchunk(node):
    """Replace flax's chunked-array maps by the arrays they hold, recursively."""
    if not isinstance(node, dict):
        return node
    if node.get(CHUNKED_KEY):
        try:
            shape = tuple(int(node["shape"][str(i)]) for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        except (KeyError, TypeError) as e:
            raise MsgpackError(f"malformed {CHUNKED_KEY} entry") from e
        return _concat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def restore(data: bytes) -> dict:
    """`flax.serialization.msgpack_restore`: the tree of nested dicts (str
    keys) with numpy leaves (torch bf16 tensors for bfloat16 arrays)."""
    tree = unpackb(data, _flax_ext)
    if not isinstance(tree, dict):
        raise MsgpackError("a flax parameter file holds a map at its top level")
    return _unchunk(tree)


# -- encoding ---------------------------------------------------------------


def _header(n: int, small: Tuple[int, int], forms) -> bytes:
    """`small` = (first byte of the fix form, its limit); `forms` = [(type
    byte, struct format, limit)] in increasing size."""
    base, limit = small
    if n < limit:
        return bytes([base | n])
    for byte, fmt, top in forms:
        if n < top:
            return bytes([byte]) + struct.pack(fmt, n)
    raise MsgpackError(f"length {n} too large for msgpack")


_STR = ((0xA0, 32), [(0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)])
_ARRAY = ((0x90, 16), [(0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)])
_MAP = ((0x80, 16), [(0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)])
_BIN = [(0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)]


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n & 0xFF])
    if n >= 0:
        for byte, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes([byte]) + struct.pack(fmt, n)
    else:
        for byte, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([byte]) + struct.pack(fmt, n)
    raise MsgpackError(f"integer {n} out of msgpack's range")


def _pack_bin(data: bytes) -> bytes:
    n = len(data)
    for byte, fmt, top in _BIN:
        if n < top:
            return bytes([byte]) + struct.pack(fmt, n) + data
    raise MsgpackError(f"bin of {n} bytes too large for msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n < 1 << 8:
        head = b"\xc7" + struct.pack(">B", n)
    elif n < 1 << 16:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack(">b", code) + data


def _array_payload(arr) -> bytes:
    """(shape, dtype name, raw bytes) of a numpy array or a torch tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb([list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()])
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes cannot be written")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def packb(obj) -> bytes:
    """Encode `obj` (dict with str keys, list/tuple, str, bytes, bool, int,
    float, None, numpy arrays and scalars, torch tensors)."""
    parts = []

    def put(x):
        if x is None:
            parts.append(b"\xc0")
        elif isinstance(x, bool):
            parts.append(b"\xc3" if x else b"\xc2")
        elif isinstance(x, int):
            parts.append(_pack_int(x))
        elif isinstance(x, float):
            parts.append(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            parts.append(_header(len(raw), *_STR) + raw)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            parts.append(_pack_bin(bytes(x)))
        elif isinstance(x, dict):
            parts.append(_header(len(x), *_MAP))
            for k, v in x.items():
                if not isinstance(k, str):
                    raise MsgpackError(f"map keys must be str, got {type(k).__name__}")
                put(k)
                put(v)
        elif isinstance(x, (list, tuple)):
            parts.append(_header(len(x), *_ARRAY))
            for v in x:
                put(v)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            parts.append(_pack_ext(NDARRAY_EXT, _array_payload(x)))
        elif isinstance(x, np.generic):
            parts.append(_pack_ext(NPSCALAR_EXT, _array_payload(np.asarray(x))))
        else:
            raise MsgpackError(f"cannot write a {type(x).__name__}")

    put(obj)
    return b"".join(parts)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's `_chunk`: an oversized array as a map of flat chunks."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = x.reshape(-1)
    return {CHUNKED_KEY: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, flat.shape[0], size))}}


def serialize(tree: dict) -> bytes:
    """`flax.serialization.to_bytes` of a tree of nested dicts (str keys),
    tuples and lists with numpy / torch leaves: tuples and lists become maps
    keyed "0", "1", ... (flax's state dict), and arrays over
    `MAX_CHUNK_SIZE` bytes are chunked as flax chunks them."""

    def chunked(node):
        if isinstance(node, dict):
            return {k: chunked(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return {str(i): chunked(v) for i, v in enumerate(node)}
        if isinstance(node, (np.ndarray, torch.Tensor)) and _nbytes(node) > MAX_CHUNK_SIZE:
            return _chunk(node)
        return node

    return packb(chunked(tree))
