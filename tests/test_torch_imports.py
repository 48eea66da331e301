"""The port stands alone: no JAX and nothing of the JAX package in its
sources or in `chip_smoke.py`, and none of the library kernels the port
must not call."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gsoc_wav2vec2_tpu_torch"
FORBIDDEN_IMPORTS = [
    re.compile(r"^\s*import\s+jax\b", re.M),
    re.compile(r"^\s*from\s+jax\b", re.M),
    re.compile(r"\bimport\s+gsoc_wav2vec2_tpu(?!_torch)\b"),
    re.compile(r"\bfrom\s+gsoc_wav2vec2_tpu\."),
    re.compile(r"\bfrom\s+gsoc_wav2vec2_tpu\s+import\b"),
    re.compile(r"^\s*import\s+(flax|optax)\b|^\s*from\s+(flax|optax)\b", re.M),
]


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.is_file() for f in files)
    return files


@pytest.mark.parametrize("pattern", FORBIDDEN_IMPORTS, ids=lambda p: p.pattern)
def test_port_imports_no_jax(pattern):
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in _sources() for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_port_calls_no_library_kernels():
    hits = [str(f.relative_to(ROOT)) for f in sorted(PORT.rglob("*.py"))
            if re.search(r"scaled_dot_product_attention|torch\.compile", f.read_text())]
    assert not hits, hits


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
