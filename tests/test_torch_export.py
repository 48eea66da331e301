"""The port's `torch.export` artifact (`export/torch_export.py`, the
counterpart of the JAX package's `export/stablehlo.py`) and the kernels'
`torch.library` operators, on the CPU.

Round trips at a fixed and a symbolic batch against the live module (bit
for bit) and against the JAX forward at the parity tolerance, the robust
family's mask, the artifact run in a process that imports the port's
kernels alone, each operator's CPU implementation against its plain version
and its fake against the real output, the CLI, and a load for the wrong
device type.  The card half (the kernels launched from the artifact) is in
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tests.test_torch_model import build_pair

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu_torch.export.torch_export import META_NAME, export_model, load_exported
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend as cf
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa
from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv as pc

torch.set_num_threads(2)
SEQLEN = 8000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _speech(b, seed):
    return np.random.RandomState(seed).randn(b, SEQLEN).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_export_fixed_batch_roundtrip(tmp_path, dtype):
    cfg, params, pcfg, model = build_pair(False)
    export_model(model, str(tmp_path), seqlen=SEQLEN, batch_size=2, compute_dtype=dtype)
    program, meta = load_exported(str(tmp_path), device="cpu")
    assert meta["seqlen"] == SEQLEN and meta["batch_size"] == 2 and meta["with_lm_head"]
    assert meta["device"] == "cpu" and meta["compute_dtype"] == str(dtype).removeprefix("torch.")
    speech = _speech(2, 0)
    got = program.module()(torch.from_numpy(speech))
    with torch.no_grad():
        live = modeling.wav2vec2_for_ctc_forward(model, pcfg, torch.from_numpy(speech),
                                                 compute_dtype=dtype)
    assert torch.equal(got, live)
    if dtype == torch.float32:
        want = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(params, cfg, jnp.asarray(speech)))
        np.testing.assert_allclose(got.numpy(), want, atol=4e-3)


def test_export_symbolic_batch(tmp_path):
    """batch_size=None: one artifact, any batch (1 included)."""
    _, _, pcfg, model = build_pair(False, seed=1)
    export_model(model, str(tmp_path), seqlen=SEQLEN, compute_dtype=torch.float32)
    program, meta = load_exported(str(tmp_path), device="cpu")
    assert meta["batch_size"] is None
    run = program.module()
    for b in (1, 3):
        x = torch.from_numpy(_speech(b, b))
        out = run(x)
        assert out.shape == (b, pcfg.conv_output_length(SEQLEN), pcfg.vocab_size)
        with torch.no_grad():
            assert torch.equal(out, model(x))


def test_export_robust_takes_mask(tmp_path):
    """The robust family exports `(speech, attention_mask)`; a ragged mask
    gives the live module's bits and the JAX forward's logits."""
    cfg, params, pcfg, model = build_pair(True, seed=2)
    export_model(model, str(tmp_path), seqlen=SEQLEN, compute_dtype=torch.float32)
    program, meta = load_exported(str(tmp_path), device="cpu")
    assert meta["with_attention_mask"]
    speech = _speech(2, 3)
    mask = np.ones((2, SEQLEN), np.float32)
    mask[1, 5000:] = 0.0
    speech[1, 5000:] = 0.0
    got = program.module()(torch.from_numpy(speech), torch.from_numpy(mask))
    with torch.no_grad():
        assert torch.equal(got, model(torch.from_numpy(speech), torch.from_numpy(mask)))
    want = np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=4e-3)


def test_backbone_export_gives_hidden_states(tmp_path):
    _, _, pcfg, model = build_pair(False, seed=4)
    export_model(model, str(tmp_path), seqlen=SEQLEN, with_lm_head=False,
                 compute_dtype=torch.float32)
    program, meta = load_exported(str(tmp_path), device="cpu")
    x = torch.from_numpy(_speech(2, 5))
    with torch.no_grad():
        want = modeling.wav2vec2_forward(model.wav2vec2, pcfg, x)
    assert not meta["with_lm_head"] and torch.equal(program.module()(x), want)


CHILD = """
import json, sys
import numpy as np, torch
from gsoc_wav2vec2_tpu_torch.export.torch_export import load_exported
program, meta = load_exported(sys.argv[1], device="cpu")
x = torch.from_numpy(np.load(sys.argv[2]))
torch.save(program.module()(x), sys.argv[3])
print(json.dumps(sorted(m for m in sys.modules if m.startswith("gsoc_wav2vec2_tpu"))))
"""


def test_exported_artifact_runs_without_model_code(tmp_path):
    """A fresh process loads and runs the artifact with the port's kernels
    (their operators) and none of its model code."""
    _, _, pcfg, model = build_pair(False, seed=5)
    art = str(tmp_path / "art")
    export_model(model, art, seqlen=SEQLEN, compute_dtype=torch.bfloat16)
    speech = _speech(2, 6)
    np.save(tmp_path / "x.npy", speech)
    proc = subprocess.run([sys.executable, "-c", CHILD, art, str(tmp_path / "x.npy"),
                           str(tmp_path / "out.pt")], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "gsoc_wav2vec2_tpu_torch.ops.kernels" in loaded
    assert not [m for m in loaded if m.startswith(("gsoc_wav2vec2_tpu_torch.models",
                                                   "gsoc_wav2vec2_tpu."))]
    with torch.no_grad():
        want = modeling.wav2vec2_for_ctc_forward(model, pcfg, torch.from_numpy(speech),
                                                 compute_dtype=torch.bfloat16)
    assert torch.equal(torch.load(tmp_path / "out.pt"), want)


@pytest.mark.parametrize("name", ["fused_conv01", "fused_conv01_robust", "pos_conv",
                                  "flash_attention_fwd"])
def test_operator_is_the_plain_version_on_cpu_and_its_fake_has_its_shape(name):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    c, n = 32, 4003
    wave = r(2, n)
    w0, w1 = r(10, 1, c) * 0.3, r(3, c, c) * 0.1
    vecs = [0.1 * r(c) + (1.0 if i % 3 == 1 else 0.0) for i in range(6)]
    x = r(2, 40, 64).to(torch.bfloat16)
    kernel, bias = r(128, 4, 64) * 0.05, r(64) * 0.1
    q, k, v = (r(2, 4, 37, 16).to(torch.bfloat16) for _ in range(3))
    kb = torch.where(torch.arange(37)[None, :] < torch.tensor([[37], [20]]), 0.0, -10000.0)
    xb = wave.to(torch.bfloat16)
    t0, t1 = cf.conv0_length(n), cf.conv1_length(n)
    cases = {
        "fused_conv01": (cf.fused_conv01_op, (wave, w0, vecs[1], vecs[0], w1, 1e-5, True),
                         lambda: cf.conv01_plain(xb, w0, *cf.groupnorm_stats_plain(
                             xb, t0, w0, vecs[1], vecs[0], 1e-5), w1, t1, True)),
        "fused_conv01_robust": (cf.fused_conv01_robust_op,
                                (wave, w0, *vecs[:3], w1, *vecs[3:], 1e-5, True),
                                lambda: cf.conv01_robust_plain(xb, w0, *vecs[:3], w1, *vecs[3:], t1,
                                                               1e-5, True)),
        "pos_conv": (pc.pos_conv_op, (x, kernel, bias, 16, True),
                     lambda: pc.pos_conv_plain(x, kernel, bias, groups=16, gelu_approx=True)),
        "flash_attention_fwd": (fa.flash_attention_fwd_op, (q, k, v, kb, 0.0, 0),
                                lambda: fa.flash_attention_fwd_plain(q, k, v, kb)),
    }
    op, args, plain = cases[name]
    assert getattr(torch.ops.w2v2, name).default is op._opoverload
    got, want = op(*args), plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    fake = fake if isinstance(fake, tuple) else (fake,)
    for f, real in zip(fake, got):
        assert (f.shape, f.dtype, f.stride()) == (real.shape, real.dtype, real.stride())


def test_export_cli(tmp_path, capsys):
    from gsoc_wav2vec2_tpu_torch.cli import export as export_cli

    _, _, pcfg, model = build_pair(False, seed=7)
    model_dir, out = str(tmp_path / "model"), str(tmp_path / "art")
    model.save_pretrained(model_dir)
    path = export_cli.main(["--model_id", model_dir, "--saved_model_dir", out, "--seqlen",
                            str(SEQLEN), "--compute_dtype", "float32", "--device", "cpu"])
    assert path == os.path.join(out, "model.pt2") and "exported to" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(out, "config.json"))
    program, meta = load_exported(out, device="cpu")
    assert meta["batch_size"] is None and meta["compute_dtype"] == "float32"
    x = torch.from_numpy(_speech(3, 8))
    with torch.no_grad():
        assert torch.equal(program.module()(x), model(x))
    # the TF SavedModel format is ported (tests/test_torch_savedmodel.py): it
    # writes the artifact where TensorFlow is installed, else names it
    sm_dir = str(tmp_path / "sm")
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="tensorflow"):
            export_cli.main(["--model_id", model_dir, "--saved_model_dir", sm_dir, "--format",
                             "saved_model", "--seqlen", str(SEQLEN), "--device", "cpu"])
    else:
        assert export_cli.main(["--model_id", model_dir, "--saved_model_dir", sm_dir, "--format",
                                "saved_model", "--seqlen", str(SEQLEN),
                                "--device", "cpu"]) == sm_dir
        assert os.path.isfile(os.path.join(sm_dir, "saved_model.pb"))


def test_cross_device_load_raises(tmp_path):
    """An artifact runs on the device type it was exported on: a CPU one
    refuses the card, a card one refuses the CPU (its meta says so)."""
    _, _, _, model = build_pair(False, seed=9)
    export_model(model, str(tmp_path), seqlen=SEQLEN, compute_dtype=torch.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_exported(str(tmp_path))
    else:
        with pytest.raises(ValueError, match="exported for cpu, not cuda"):
            load_exported(str(tmp_path))
    meta_path = tmp_path / META_NAME
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        load_exported(str(tmp_path), device="cpu")
