"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by `nvcc`, one process
per source started together, and the objects are linked into one shared
library with a plain C interface, loaded through `ctypes`.  The build runs
at first use, into `_build/` beside the package (listed in `.gitignore`);
a library built from the same sources is reused.  A failed build raises:
nothing falls back.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()` after the launch; `check` raises on anything but 0.

    python -c "from gsoc_wav2vec2_tpu_torch.ops.kernels import _build; print(_build.ptxas_report())"

compiles every source once more with `-Xptxas -v` (in parallel, nothing
kept) and prints each kernel's registers, spills and shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
# held through `build`: threads of one process share its object directory
_BUILD_LOCK = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float
LL = ctypes.c_longlong
# q, k, v, bias, out, lse, BH, H, L, D, stride_b, stride_h, stride_l,
# seed, threshold, hash_stride, inv_keep, dropout, stream
_FLASH_FWD = [P, P, P, P, P, P, I, I, I, I, LL, LL, LL, I, U, U, F, I, P]
# q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L, D,
# qkv strides (b, h, l), out strides, dout strides,
# seed, threshold, hash_stride, inv_keep, dropout, stream
_FLASH_BWD = [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
              LL, LL, LL, LL, LL, LL, LL, LL, LL, I, U, U, F, I, P]
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    # x, w0 (10, C) f32, gamma, beta, scale, shift, B, L, ld, t0, C, eps, stream
    "w2v2_groupnorm_stats": [P, P, P, P, P, P, I, I, I, I, I, F, P],
    # x, w0 (16 taps), scale, shift, w1, out, B, L, T1, C, stream
    "w2v2_conv01": [P, P, P, P, P, P, I, I, I, I, P],
    # x, w0 (16 taps), p0 [bias, gamma, beta], w1, p1, out, B, L, T1, C, eps, stream
    "w2v2_conv01_robust": [P, P, P, P, P, P, I, I, I, I, F, P],
    # x, w, bias, out, B, T, C, G, K, stream
    "w2v2_pos_conv": [P, P, P, P, I, I, I, I, I, P],
    # x, w, bias, out, pre, B, T, C, G, K, stream
    "w2v2_pos_conv_train_fwd": [P, P, P, P, P, I, I, I, I, I, P],
    # dpre, w_flipped, dx, B, T, C, G, K, stream
    "w2v2_pos_conv_dx": [P, P, P, I, I, I, I, I, P],
    # x, dpre, part, dw, B, T, C, G, K, splits, stream
    "w2v2_pos_conv_dw": [P, P, P, P, I, I, I, I, I, I, P],
    # the flash kernels, bf16 (`csrc/flash_attention.cu`) and f32 (`_f32.cu`
    # at head dim 64, `_f32_wide.cu` at 128-256)
    "w2v2_flash_fwd": _FLASH_FWD, "w2v2_flash_fwd_f32": _FLASH_FWD,
    "w2v2_flash_fwd_f32_wide": _FLASH_FWD,
    "w2v2_flash_bwd": _FLASH_BWD, "w2v2_flash_bwd_f32": _FLASH_BWD,
    "w2v2_flash_bwd_f32_wide": _FLASH_BWD,
    # dneg, idx, order, start, off, ticket, work, part, meta, out,
    # B, N, D, ld, L, shares, bf16, stream
    "w2v2_scatter_rows_add": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    # log_probs, labels, lengths, states, loss, B, T, V, N, pad,
    # the plan's P, W, F, R, Ro, stride, bulk, stream
    "w2v2_ctc_fwd": [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P],
    # log_probs, labels, lengths, states, gloss, dl, order, offsets, blank,
    # grad, B, T, V, N, pad, the plan's W, G, D, F, Ro, stream
    "w2v2_ctc_bwd": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    # in, out, iters, backward, stream
    "w2v2_ctc_chain_probe": [P, P, I, I, P],
    # bad, stream
    "w2v2_ctc_log1p_check": [P, P],
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


def _compile_all(out_of, extra=()):
    """One nvcc per source, all started together; [(source, output)] in
    source order.  Raises `RuntimeError` with the output of every failure."""
    nvcc = find_nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(out_of(src))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )) for src in _sources()]
    outputs, failures = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        outputs.append((src, out))
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return outputs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  Raises `RuntimeError` with the compiler's output
    when any step fails.  Thread-safe: a second caller waits for the first
    build and reuses its library."""
    with _BUILD_LOCK:
        return _build_locked()


def _build_locked() -> Path:
    lib_path = BUILD_DIR / f"libw2v2_kernels_{_digest()}.so"
    if lib_path.is_file():
        return lib_path
    # objects per process, so that concurrent first uses in two processes
    # cannot clobber each other (threads of one process wait on _BUILD_LOCK)
    obj_dir = BUILD_DIR / f"obj-{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / f"{src.stem}.o" for src in _sources()]
    _compile_all(lambda src: obj_dir / f"{src.stem}.o")  # same order as `objs`
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [find_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
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
    `restype` set for every entry point.  Two threads that reach the first
    use together both wait on `build`'s lock, and the second loads the
    first one's library."""
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


def ptxas_report() -> str:
    """Registers, spills, shared memory and warnings (C7514: wgmma
    serialized) of every kernel, from a `-Xptxas -v` compile of each source
    (objects discarded)."""
    lines = []
    for src, out in _compile_all(lambda src: os.devnull, ("-Xptxas", "-v")):
        lines.append(f"== {src.name}")
        lines += [ln for ln in out.splitlines()
                  if any(w in ln for w in ("Compiling entry", "registers", "spill", "warning"))]
    return "\n".join(lines)
