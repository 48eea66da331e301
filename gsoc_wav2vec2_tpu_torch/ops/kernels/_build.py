"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by `nvcc`, one process
per source started together, and the objects are linked into one shared
library with a plain C interface, loaded through `ctypes`.  The build runs
at first use, into `_build/` beside the package (listed in `.gitignore`);
a library built from the same sources is reused.  A failed build raises:
nothing falls back.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()` after the launch; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    # x, out, B, L, na, nb, stream
    "w2v2_window_stats": [P, P, I, I, I, I, P],
    # x, w0, scale, shift, w1, out, B, L, T1, C, stream
    "w2v2_conv01": [P, P, P, P, P, P, I, I, I, I, P],
    # x, w, bias, out, B, T, C, G, K, stream
    "w2v2_pos_conv": [P, P, P, P, I, I, I, I, I, P],
    # q, k, v, bias, out, lse, BH, H, L, D, stride_b, stride_h, stride_l, stream
    "w2v2_flash_fwd": [P, P, P, P, P, P, I, I, I, I, LL, LL, LL, P],
}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  Raises `RuntimeError` with the compiler's output
    when any step fails."""
    lib_path = BUILD_DIR / f"libw2v2_kernels_{_digest()}.so"
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    # objects per process, so that concurrent first uses cannot clobber each other
    obj_dir = BUILD_DIR / f"obj-{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = obj_dir / f"{src.stem}.o"
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir)
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use, with `argtypes` and
    `restype` set for every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.w2v2_error_string.argtypes = [ctypes.c_int]
    lib.w2v2_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().w2v2_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
