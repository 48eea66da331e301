"""The port's ONNX export (`export/onnx_export.py` and its copies of the
numpy-only `onnx_proto.py`, `onnx_numpy.py`, `onnx_subset.proto`) against
the JAX package's, on the CPU.

Fed the same weights (the port's state dict through `params_to_jax`), the
port's `model.onnx` is byte-equal to the JAX `export_onnx`'s, for the base
and robust families and the bare backbone; the port's evaluator runs it to
the JAX f32 forward's logits (atol 1e-4) and the same greedy transcripts;
the port's `.proto` copy parses it under `protoc`; the CLI writes it.
"""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import build_pair
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.export.onnx_export import export_onnx as jax_export_onnx
from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_to_jax
from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor
from gsoc_wav2vec2_tpu_torch.export import onnx_proto as P
from gsoc_wav2vec2_tpu_torch.export.onnx_export import IR_VERSION, OPSET_VERSION, export_onnx
from gsoc_wav2vec2_tpu_torch.export.onnx_numpy import OnnxModel

torch.set_num_threads(2)
SEQLEN = 8000
PROTO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "gsoc_wav2vec2_tpu_torch", "export")

requires_protoc = pytest.mark.skipif(shutil.which("protoc") is None, reason="requires protoc")


@pytest.fixture(scope="module")
def base_artifact(tmp_path_factory):
    cfg, params, pcfg, model = build_pair(False)
    path = export_onnx(pcfg, params_to_jax(model.state_dict()),
                       str(tmp_path_factory.mktemp("onnx_base")), seqlen=SEQLEN)
    return cfg, params, path


@pytest.mark.parametrize("robust,head", [(False, True), (True, True), (False, False)],
                         ids=["base", "robust", "base_backbone"])
def test_bytes_equal_the_jax_export(tmp_path, robust, head):
    cfg, params, pcfg, model = build_pair(robust, with_head=head, seed=3)
    ours = export_onnx(pcfg, params_to_jax(model.state_dict()), str(tmp_path / "port"),
                       seqlen=SEQLEN, with_lm_head=head)
    theirs = jax_export_onnx(cfg, params, str(tmp_path / "jax"), seqlen=SEQLEN, with_lm_head=head)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with open(tmp_path / "port" / "export_meta.json") as a, open(tmp_path / "jax" / "export_meta.json") as b:
        assert a.read() == b.read()


def _jax_logits(params, cfg, speech, mask=None):
    return np.asarray(jax_modeling.wav2vec2_for_ctc_forward(
        params, cfg, jnp.asarray(speech), None if mask is None else jnp.asarray(mask),
        training=False, compute_dtype=jnp.float32))


def test_numpy_eval_matches_jax_base(base_artifact):
    cfg, params, path = base_artifact
    model = OnnxModel(path)
    assert model.input_names == ["speech"]
    speech = np.random.RandomState(0).randn(2, SEQLEN).astype(np.float32)
    (got,) = model.run({"speech": speech})
    want = _jax_logits(params, cfg, speech)
    assert got.shape == want.shape == (2, cfg.conv_output_length(SEQLEN), 32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_numpy_eval_matches_jax_robust_with_ragged_mask(tmp_path):
    cfg, params, pcfg, model = build_pair(True, seed=1)
    path = export_onnx(pcfg, params_to_jax(model.state_dict()), str(tmp_path), seqlen=SEQLEN)
    onnx_model = OnnxModel(path)
    assert onnx_model.input_names == ["speech", "attention_mask"]
    speech = np.random.RandomState(1).randn(2, SEQLEN).astype(np.float32)
    mask = np.zeros((2, SEQLEN), np.float32)
    mask[0, :] = 1.0
    mask[1, :5000] = 1.0
    (got,) = onnx_model.run({"speech": speech, "attention_mask": mask})
    np.testing.assert_allclose(got, _jax_logits(params, cfg, speech, mask), atol=1e-4)


def test_greedy_transcription_equality(base_artifact):
    cfg, params, path = base_artifact
    tokenizer = Wav2Vec2Processor(is_tokenizer=True)
    speech = np.random.RandomState(7).randn(1, SEQLEN).astype(np.float32)
    (onnx_logits,) = OnnxModel(path).run({"speech": speech})
    jax_logits = _jax_logits(params, cfg, speech)
    assert tokenizer.decode(np.argmax(onnx_logits[0], -1).tolist()) == tokenizer.decode(
        np.argmax(jax_logits[0], -1).tolist())


@requires_protoc
def test_artifact_parses_under_the_ports_proto_copy(base_artifact, tmp_path):
    """protoc compiles the port's `onnx_subset.proto` into google.protobuf
    bindings, which parse the artifact field for field as the port's own
    decoder does."""
    _, _, path = base_artifact
    subprocess.run(["protoc", f"--python_out={tmp_path}", f"--proto_path={PROTO_DIR}",
                    "onnx_subset.proto"], check=True)
    sys.path.insert(0, str(tmp_path))
    try:
        import onnx_subset_pb2 as pb
    finally:
        sys.path.remove(str(tmp_path))
    with open(path, "rb") as f:
        blob = f.read()
    model = pb.ModelProto()
    model.ParseFromString(blob)
    assert model.ir_version == IR_VERSION and model.opset_import[0].version == OPSET_VERSION
    assert model.graph.input[0].name == "speech"
    dim = model.graph.input[0].type.tensor_type.shape.dim
    assert dim[0].dim_param == "batch" and dim[1].dim_value == SEQLEN
    assert model.graph.output[0].name == "logits"
    available = {t.name for t in model.graph.initializer} | {vi.name for vi in model.graph.input}
    for node in model.graph.node:
        assert all(name in available for name in node.input), node.op_type
        available.update(node.output)
    ours = P.decode_model(blob)
    assert [n["op_type"] for n in ours["graph"]["node"]] == [n.op_type for n in model.graph.node]
    for a, b in zip(ours["graph"]["initializer"], model.graph.initializer):
        assert (a["name"], list(a["dims"]), a["data_type"], a["raw_data"]) == (
            b.name, list(b.dims), b.data_type, b.raw_data)


def test_export_cli_onnx(tmp_path):
    from gsoc_wav2vec2_tpu_torch.cli import export as export_cli

    cfg, params, _, model = build_pair(False, seed=2)
    model_dir, out = str(tmp_path / "model"), str(tmp_path / "onnx_out")
    model.save_pretrained(model_dir)
    path = export_cli.main(["--model_id", model_dir, "--saved_model_dir", out, "--seqlen",
                            str(SEQLEN), "--format", "onnx", "--device", "cpu"])
    assert path == os.path.join(out, "model.onnx")
    assert os.path.isfile(os.path.join(out, "config.json"))
    jax_path = jax_export_onnx(tiny_config(), params, str(tmp_path / "jax"), seqlen=SEQLEN)
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    speech = np.random.RandomState(3).randn(1, SEQLEN).astype(np.float32)
    (got,) = OnnxModel(path).run({"speech": speech})
    np.testing.assert_allclose(got, _jax_logits(params, cfg, speech), atol=1e-4)
