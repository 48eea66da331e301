"""The port's TF SavedModel export (`export/savedmodel.py`, `cli.export
--format saved_model`) against the JAX package's (`export/savedmodel.py`,
through jax2tf), on the CPU.

Both artifacts are written from the same weights (the JAX initialiser's
tree; the port's model gets it through the weight bridge) and loaded with
plain TensorFlow, no model code.  float32: the port's logits equal the JAX
artifact's and the port's f32 forward within 1e-4 (the JAX export test's
tolerance), at batch 1 and 3 through one artifact, and for the robust family
with a ragged `attention_mask`.  bfloat16: within 5% of the logit scale of
the JAX bf16 artifact with argmax agreeing on >= 90% of frames (the card
checks' bf16 bound), and not the f32 artifact's logits.  The signatures take
and give the same keys.  Without TensorFlow the format raises ImportError.
"""

import builtins
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from tests.test_torch_model import build_pair  # noqa: E402

from gsoc_wav2vec2_tpu.export.savedmodel import export_saved_model as jax_export  # noqa: E402
from gsoc_wav2vec2_tpu.models.config import Wav2Vec2Config  # noqa: E402
from gsoc_wav2vec2_tpu.models.modeling import init_wav2vec2_for_ctc_params  # noqa: E402
from gsoc_wav2vec2_tpu_torch.cli import export as export_cli  # noqa: E402
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax, params_to_jax  # noqa: E402
from gsoc_wav2vec2_tpu_torch.export.savedmodel import export_saved_model  # noqa: E402
from gsoc_wav2vec2_tpu_torch.models import config as port_config  # noqa: E402
from gsoc_wav2vec2_tpu_torch.models.modeling import (  # noqa: E402
    Wav2Vec2ForCTC,
    wav2vec2_for_ctc_forward,
)

torch.set_num_threads(2)
SEQLEN = 16000
ATOL = 1e-4
BF16_SCALE_SHARE, BF16_ARGMAX = 0.05, 0.9


def _tiny():
    """`tests/test_export.py`'s SavedModel config, the JAX params of seed 0
    and the port's model on them."""
    config = Wav2Vec2Config(hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
                            filter_sizes=[32, 32], kernal_sizes=[10, 3], strides=[5, 2],
                            dropout=0.0, apply_spec_augment=False)
    params = init_wav2vec2_for_ctc_params(jax.random.PRNGKey(0), config)
    pcfg = port_config.Wav2Vec2Config(**dataclasses.asdict(config))
    model = Wav2Vec2ForCTC(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return config, params, pcfg, model


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The port's and the JAX package's SavedModels in f32 and bf16, loaded."""
    config, params, pcfg, model = _tiny()
    root = tmp_path_factory.mktemp("savedmodel")
    loaded = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        port_dir, jax_dir = str(root / f"port_{name}"), str(root / f"jax_{name}")
        export_saved_model(pcfg, params_to_jax(model.state_dict()), port_dir, seqlen=SEQLEN,
                           compute_dtype=dtype)
        jax_export(config, params, jax_dir, seqlen=SEQLEN, platforms=("cpu",),
                   compute_dtype=getattr(jnp, dtype))
        loaded[name] = (tf.saved_model.load(port_dir), tf.saved_model.load(jax_dir))
    return loaded, pcfg, model


def _speech(b, seed=0):
    return np.random.RandomState(seed).randn(b, SEQLEN).astype(np.float32)


def _port_forward(model, config, speech, mask=None):
    with torch.no_grad():
        return wav2vec2_for_ctc_forward(
            model, config, torch.from_numpy(speech),
            None if mask is None else torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("batch", [1, 3])
def test_f32_logits_equal_the_jax_artifact_and_the_port_forward(artifacts, batch):
    loaded, pcfg, model = artifacts
    port, theirs = loaded["f32"]
    speech = _speech(batch, seed=batch)
    got = port(tf.constant(speech)).numpy()
    assert got.shape == (batch, pcfg.conv_output_length(SEQLEN), pcfg.vocab_size)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, theirs(tf.constant(speech)).numpy(), atol=ATOL)
    np.testing.assert_allclose(got, _port_forward(model, pcfg, speech), atol=ATOL)


def test_bf16_artifact_within_the_bf16_bound_of_the_jax_bf16_artifact(artifacts):
    loaded, _, _ = artifacts
    port, theirs = loaded["bf16"]
    speech = _speech(3, seed=4)
    got, want = port(tf.constant(speech)).numpy(), theirs(tf.constant(speech)).numpy()
    scale = float(np.abs(want).max())
    assert got.dtype == want.dtype == np.float32
    assert float(np.abs(got - want).max()) <= BF16_SCALE_SHARE * scale
    assert float((got.argmax(-1) == want.argmax(-1)).mean()) >= BF16_ARGMAX
    # a bf16 artifact, not the f32 one: its logits carry bf16 rounding
    f32 = loaded["f32"][0](tf.constant(speech)).numpy()
    assert float(np.abs(got - f32).max()) > 100 * ATOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_signature_keys_equal_the_jax_artifacts(artifacts, dtype):
    loaded, _, _ = artifacts
    port, theirs = (m.signatures["serving_default"] for m in loaded[dtype])
    args, kwargs = port.structured_input_signature
    assert not args and list(kwargs) == ["speech"]
    assert port.structured_input_signature == theirs.structured_input_signature
    assert kwargs["speech"].shape.as_list() == [None, SEQLEN]
    assert {k: (v.dtype, v.shape.as_list()) for k, v in port.structured_outputs.items()} == \
        {k: (v.dtype, v.shape.as_list()) for k, v in theirs.structured_outputs.items()}
    assert list(port.structured_outputs) == ["output_0"]


def test_weights_are_trainable_variables(artifacts):
    """A TFHub user can fine-tune the artifact: its weights are variables and
    the loaded function has gradients for them."""
    port, _ = artifacts[0]["f32"]
    params = list(port._params)
    assert params and all(v.trainable for v in params)
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(port(tf.constant(_speech(1))) ** 2)
    grads = tape.gradient(loss, params)
    assert all(g is not None for g in grads)
    assert sum(float(tf.reduce_sum(tf.abs(g))) for g in grads) > 0


def test_robust_artifact_takes_a_ragged_attention_mask(tmp_path):
    cfg, params, pcfg, model = build_pair(True, seed=1)
    seqlen = 8000
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    export_saved_model(pcfg, params_to_jax(model.state_dict()), port_dir, seqlen=seqlen)
    jax_export(cfg, params, jax_dir, seqlen=seqlen, platforms=("cpu",))
    port, theirs = tf.saved_model.load(port_dir), tf.saved_model.load(jax_dir)
    sig = port.signatures["serving_default"]
    assert sorted(sig.structured_input_signature[1]) == ["attention_mask", "speech"]
    assert sig.structured_input_signature == theirs.signatures["serving_default"].structured_input_signature
    speech = np.random.RandomState(2).randn(3, seqlen).astype(np.float32)
    mask = np.ones((3, seqlen), np.float32)
    for i, n in enumerate((seqlen, 5000, 2600)):
        mask[i, n:] = 0.0
        speech[i, n:] = 0.0
    got = port(tf.constant(speech), tf.constant(mask)).numpy()
    np.testing.assert_allclose(got, theirs(tf.constant(speech), tf.constant(mask)).numpy(), atol=ATOL)
    np.testing.assert_allclose(got, _port_forward(model, pcfg, speech, mask), atol=ATOL)
    # the serving signature, keyed, gives the same logits
    keyed = sig(speech=tf.constant(speech), attention_mask=tf.constant(mask))["output_0"].numpy()
    np.testing.assert_array_equal(keyed, got)


def test_export_cli_writes_a_saved_model(tmp_path, capsys):
    _, _, pcfg, model = _tiny()
    model_dir, out = str(tmp_path / "model"), str(tmp_path / "sm")
    model.save_pretrained(model_dir)
    path = export_cli.main(["--model_id", model_dir, "--saved_model_dir", out, "--format",
                            "saved_model", "--seqlen", str(SEQLEN), "--compute_dtype", "float32",
                            "--device", "cpu"])
    assert path == out and "exported to" in capsys.readouterr().out
    speech = _speech(2, seed=9)
    got = tf.saved_model.load(out)(tf.constant(speech)).numpy()
    np.testing.assert_allclose(got, _port_forward(model, pcfg, speech), atol=ATOL)


def test_saved_model_without_tensorflow_raises_import_error(tmp_path, monkeypatch):
    """No fallback to another format: the import error names tensorflow."""
    _, _, _, model = _tiny()
    model_dir = str(tmp_path / "model")
    model.save_pretrained(model_dir)
    real_import = builtins.__import__

    def no_tensorflow(name, *a, **kw):
        if name == "tensorflow" or name.startswith("tensorflow."):
            raise ImportError("No module named 'tensorflow'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorflow)
    with pytest.raises(ImportError, match="tensorflow"):
        export_cli.main(["--model_id", model_dir, "--saved_model_dir", str(tmp_path / "sm"),
                         "--format", "saved_model", "--seqlen", str(SEQLEN), "--device", "cpu"])
    assert not (tmp_path / "sm").exists()
