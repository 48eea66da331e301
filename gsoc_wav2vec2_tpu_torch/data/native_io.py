"""ctypes bindings of the port's native IO library (`native/w2v2io.cc`).

The port's own copy of the JAX package's codec (`data/native/w2v2io.cc`,
byte for byte) and of its Python API (`data/native_io.py`): a TFRecord +
Example codec wire-compatible with `tf.data` for the {"speech": float32,
"label": int32} schema, and RIFF PCM16 WAV and FLAC decoders, with no
TensorFlow and no soundfile.

The library is built on first use with `g++` into `_build/` beside the
package (listed in `.gitignore`), under a name that carries a digest of the
source and the flags, so a changed source builds anew and an unchanged one
is reused.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "w2v2io.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_INTP = ctypes.POINTER(ctypes.c_int)
# entry point -> (restype, argtypes)
SIGNATURES = {
    "w2v2_writer_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "w2v2_writer_write": (ctypes.c_int, [ctypes.c_void_p, _F32P, ctypes.c_int64, _I32P,
                                         ctypes.c_int64]),
    "w2v2_writer_close": (None, [ctypes.c_void_p]),
    "w2v2_reader_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "w2v2_reader_open_buffer": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64]),
    "w2v2_reader_next": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(_F32P), _I64P,
                                        ctypes.POINTER(_I32P), _I64P]),
    "w2v2_reader_close": (None, [ctypes.c_void_p]),
    "w2v2_decode_wav": (ctypes.c_int64, [ctypes.c_char_p, ctypes.POINTER(_F32P), _INTP, _INTP]),
    "w2v2_decode_flac": (ctypes.c_int64, [ctypes.c_char_p, ctypes.POINTER(_F32P), _INTP, _INTP]),
    "w2v2_decode_wav_buffer": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64,
                                                ctypes.POINTER(_F32P), _INTP, _INTP]),
    "w2v2_decode_flac_buffer": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64,
                                                 ctypes.POINTER(_F32P), _INTP, _INTP]),
    "w2v2_free": (None, [ctypes.c_void_p]),
    "w2v2_decode_flac_batch": (None, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                      ctypes.c_int, ctypes.POINTER(_F32P), _I64P, _INTP]),
}


def library_path() -> Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libw2v2io_{h.hexdigest()[:16]}.so"


# held through `build`: the threads of one process (a server's handlers
# decoding their first requests) share one temporary name
_BUILD_LOCK = threading.Lock()


def build() -> Path:
    """Compile the codec (once per source digest); returns the library's
    path.  Raises `RuntimeError` with the compiler's output on failure."""
    with _BUILD_LOCK:
        lib_path = library_path()
        if lib_path.is_file():
            return lib_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a name per process, renamed into place: concurrent first uses never
        # load a half-written library
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} with {cxx} failed:\n{proc.stdout}")
        os.replace(tmp, lib_path)
        return lib_path


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use, with `restype` and `argtypes`
    set for every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


class TFRecordWriter:
    """tf.io.TFRecordWriter-compatible writer for the reference's
    {"speech": float32, "label": int32} Example schema."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._handle = self._lib.w2v2_writer_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open {path} for writing")

    def write(self, speech: np.ndarray, label: np.ndarray) -> None:
        speech = np.ascontiguousarray(speech, np.float32)
        label = np.ascontiguousarray(label, np.int32)
        rc = self._lib.w2v2_writer_write(
            self._handle, speech.ctypes.data_as(_F32P), speech.size,
            label.ctypes.data_as(_I32P), label.size,
        )
        if rc != 0:
            raise OSError("tfrecord write failed")

    def close(self) -> None:
        if self._handle:
            self._lib.w2v2_writer_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(path: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (speech float32[T], label int32[U]) from a TFRecord shard."""
    lib = get_lib()
    handle = lib.w2v2_reader_open(path.encode())
    if not handle:
        raise OSError(f"cannot open {path}")
    yield from _drain_reader(lib, handle, path)


def read_tfrecords_bytes(data: bytes, name: str = "<buffer>"):
    """`read_tfrecords` over an in-memory shard (e.g. fetched from a bucket);
    `name` only labels error messages."""
    if not data:
        return
    lib = get_lib()
    # `data` stays referenced by this generator while the reader reads it
    handle = lib.w2v2_reader_open_buffer(data, len(data))
    if not handle:
        raise OSError(f"cannot open in-memory tfrecord {name}")
    yield from _drain_reader(lib, handle, name)


def _drain_reader(lib, handle, path: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    try:
        speech_p, label_p = _F32P(), _I32P()
        slen, llen = ctypes.c_int64(), ctypes.c_int64()
        while True:
            rc = lib.w2v2_reader_next(handle, ctypes.byref(speech_p), ctypes.byref(slen),
                                      ctypes.byref(label_p), ctypes.byref(llen))
            if rc == 0:
                return
            if rc < 0:
                raise OSError(f"corrupt tfrecord in {path}")
            speech = np.ctypeslib.as_array(speech_p, (slen.value,)).copy()
            label = np.ctypeslib.as_array(label_p, (llen.value,)).copy()
            yield speech, label
    finally:
        lib.w2v2_reader_close(handle)


def _take(lib, n: int, out, name: str) -> np.ndarray:
    if n < 0:
        raise OSError(f"failed to decode {name}")
    try:
        return np.ctypeslib.as_array(out, (n,)).copy() if n else np.zeros(0, np.float32)
    finally:
        lib.w2v2_free(out)


def _decode(fn_name: str, path: str) -> Tuple[np.ndarray, int]:
    lib = get_lib()
    out, rate, channels = _F32P(), ctypes.c_int(), ctypes.c_int()
    n = getattr(lib, fn_name)(path.encode(), ctypes.byref(out), ctypes.byref(rate),
                              ctypes.byref(channels))
    return _take(lib, n, out, path), rate.value


def _decode_buffer(fn_name: str, data: bytes, name: str) -> Tuple[np.ndarray, int]:
    lib = get_lib()
    out, rate, channels = _F32P(), ctypes.c_int(), ctypes.c_int()
    n = getattr(lib, fn_name)(data, len(data), ctypes.byref(out), ctypes.byref(rate),
                              ctypes.byref(channels))
    return _take(lib, n, out, name), rate.value


def decode_wav(path: str) -> Tuple[np.ndarray, int]:
    """RIFF PCM16 -> (float32 in [-1, 1), sample_rate), first channel; the
    scaling of `tf.audio.decode_wav` (x / 32768)."""
    return _decode("w2v2_decode_wav", path)


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """FLAC -> (float32 in [-1, 1), sample_rate), first channel; the scaling
    `soundfile.read` gives PCM16 FLAC."""
    return _decode("w2v2_decode_flac", path)


def decode_wav_bytes(data: bytes, name: str = "<buffer>") -> Tuple[np.ndarray, int]:
    """`decode_wav` over in-memory bytes (remote-storage path)."""
    return _decode_buffer("w2v2_decode_wav_buffer", data, name)


def decode_flac_bytes(data: bytes, name: str = "<buffer>") -> Tuple[np.ndarray, int]:
    """`decode_flac` over in-memory bytes (remote-storage path)."""
    return _decode_buffer("w2v2_decode_flac_buffer", data, name)


def decode_flac_batch(paths: List[str], num_threads: int = 8) -> list:
    """Decode many FLAC files in the library's thread pool (ctypes releases
    the interpreter lock for the call): [(float32 audio, sample_rate)] in
    input order; a file that fails raises `OSError` naming it."""
    lib = get_lib()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (_F32P * n)()
    lens = (ctypes.c_int64 * n)()
    rates = (ctypes.c_int * n)()
    lib.w2v2_decode_flac_batch(c_paths, n, num_threads, outs, lens, rates)
    results = []
    try:
        for i in range(n):
            if lens[i] < 0:
                raise OSError(f"failed to decode {paths[i]}")
            results.append((np.ctypeslib.as_array(outs[i], (lens[i],)).copy()
                            if lens[i] else np.zeros(0, np.float32), rates[i]))
    finally:
        for i in range(n):
            if lens[i] >= 0 and outs[i]:
                lib.w2v2_free(outs[i])
    return results


def read_sound(path: str) -> Tuple[np.ndarray, int]:
    """Dispatch on extension (.flac / .wav, case-insensitive)."""
    low = path.lower()
    if low.endswith(".flac"):
        return decode_flac(path)
    if low.endswith(".wav"):
        return decode_wav(path)
    raise ValueError(f"unsupported audio format: {path}")
