"""The port stands alone: no JAX and nothing of the JAX package in its
sources or in `chip_smoke.py`, none of the packages the card's machine lacks
(msgpack, safetensors, orbax, soundfile; fsspec, wandb, h5py, transformers,
huggingface_hub and tensorflow only inside the function that needs them),
and none of the library kernels the port must not call."""

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
    re.compile(r"^\s*(import|from)\s+(msgpack|safetensors|orbax|soundfile)\b", re.M),
    # at module scope (no indentation): these load only where used
    re.compile(r"^(import|from)\s+(fsspec|wandb|h5py|transformers|huggingface_hub)\b", re.M),
    # TensorFlow only inside the SavedModel export (the card's machine has none)
    re.compile(r"^(import|from)\s+tensorflow\b", re.M),
]
# what a fresh interpreter may not hold after importing every module of the port
ABSENT_AFTER_IMPORT = ("jax", "gsoc_wav2vec2_tpu", "flax", "msgpack", "safetensors", "orbax",
                       "soundfile", "fsspec", "wandb", "h5py", "transformers", "huggingface_hub",
                       "tensorflow")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.is_file() for f in files)
    return files


@pytest.mark.parametrize("pattern", FORBIDDEN_IMPORTS, ids=lambda p: p.pattern)
def test_port_imports_no_jax(pattern):
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in _sources() for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_sources_cover_training():
    names = {str(f.relative_to(PORT)) for f in _sources() if PORT in f.parents}
    assert {"training/__init__.py", "training/state.py", "training/trainer.py",
            "models/pretraining.py", "ops/kernels/scatter_add.py", "cli/pretrain.py",
            "training/checkpoint.py", "cli/train.py", "cli/evaluate.py", "cli/average.py",
            "cli/make_tfrecords.py", "data/loaders.py", "data/native_io.py", "data/remote.py",
            "convert/flax_msgpack.py", "convert/safetensors_io.py", "utils/logging.py",
            "decoding.py", "streaming.py", "cli/align.py", "cli/serve.py",
            "cli/serve_bench.py", "convert/h5_to_torch.py", "convert/torch_to_h5.py",
            "cli/convert.py", "cli/export.py", "export/onnx_proto.py", "export/onnx_numpy.py",
            "export/onnx_export.py", "export/torch_export.py", "utils/profiling.py",
            "parallel/__init__.py", "parallel/mesh.py", "parallel/partition.py",
            "parallel/multihost.py", "export/savedmodel.py"} <= names


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter that imports every module of the port, training/*
    and the CLIs included, has none of `ABSENT_AFTER_IMPORT` in `sys.modules`
    (and builds nothing: no compiler runs at import)."""
    mods = sorted(
        ".".join(("gsoc_wav2vec2_tpu_torch",) + f.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for f in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {ABSENT_AFTER_IMPORT!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert {"gsoc_wav2vec2_tpu_torch.training.trainer", "gsoc_wav2vec2_tpu_torch.models.pretraining",
            "gsoc_wav2vec2_tpu_torch.ops.kernels.scatter_add",
            "gsoc_wav2vec2_tpu_torch.cli.pretrain", "gsoc_wav2vec2_tpu_torch.cli.train",
            "gsoc_wav2vec2_tpu_torch.data.native_io", "gsoc_wav2vec2_tpu_torch.decoding",
            "gsoc_wav2vec2_tpu_torch.streaming", "gsoc_wav2vec2_tpu_torch.cli.align",
            "gsoc_wav2vec2_tpu_torch.cli.serve", "gsoc_wav2vec2_tpu_torch.cli.serve_bench",
            "gsoc_wav2vec2_tpu_torch.cli.convert", "gsoc_wav2vec2_tpu_torch.cli.export",
            "gsoc_wav2vec2_tpu_torch.convert.h5_to_torch",
            "gsoc_wav2vec2_tpu_torch.convert.torch_to_h5",
            "gsoc_wav2vec2_tpu_torch.export.onnx_export",
            "gsoc_wav2vec2_tpu_torch.export.torch_export",
            "gsoc_wav2vec2_tpu_torch.utils.profiling", "gsoc_wav2vec2_tpu_torch.parallel",
            "gsoc_wav2vec2_tpu_torch.parallel.mesh", "gsoc_wav2vec2_tpu_torch.parallel.partition",
            "gsoc_wav2vec2_tpu_torch.parallel.multihost",
            "gsoc_wav2vec2_tpu_torch.export.savedmodel"} <= set(mods)


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


def test_tensorflow_only_inside_the_saved_model_export():
    """`export/savedmodel.py` imports tensorflow in `export_saved_model`'s
    body alone, and the sharded server's modules import neither it nor
    JAX (the module-scope patterns above cover every file)."""
    import ast

    src = (PORT / "export" / "savedmodel.py").read_text()
    found = []
    for fn in ast.walk(ast.parse(src)):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if isinstance(node, ast.Import) and any(a.name == "tensorflow" for a in node.names):
                    found.append(fn.name)
    assert found == ["export_saved_model"]
    for rel in ("cli/serve.py", "evaluation.py", "parallel/multihost.py"):
        text = (PORT / rel).read_text()
        assert not re.search(r"\b(import|from)\s+(tensorflow|jax)\b", text), rel
