"""The port's weight files against the JAX package, on the CPU.

`save_pretrained` / `from_pretrained` both ways with the JAX package's own
`save_pretrained` / `from_pretrained` (bit-equal parameters; logits within
the 4e-3 of `tests/test_parity.py`), for the base and robust families, the
bare backbone and the pretraining model; the port's msgpack codec against
`flax.serialization` (bytes, bfloat16 trees, chunked arrays); safetensors
written by the `safetensors` package and by `transformers`; the config
replace; the refusals; a `memory://` round trip through fsspec.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_torch_model import port_config_of
from tests.utils import matching_hf_config, requires_transformers, tiny_config, tiny_pretraining_config

from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu import Wav2Vec2Model as JaxWav2Vec2Model
from gsoc_wav2vec2_tpu.models import pretraining as jax_pretraining
from gsoc_wav2vec2_tpu_torch.convert import flax_msgpack, safetensors_io
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax, params_to_jax
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC, Wav2Vec2Model
from gsoc_wav2vec2_tpu_torch.models.pretraining import Wav2Vec2ForPreTraining

torch.set_num_threads(2)
SAMPLES = 8000


def _speech(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, SAMPLES)).astype(np.float32)


def _assert_state_equals_tree(sd, tree):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert set(sd) == set(want)
    for name, t in want.items():
        assert sd[name].dtype == t.dtype, name
        assert torch.equal(sd[name], t), name


FAMILIES = [(False, JaxWav2Vec2ForCTC, Wav2Vec2ForCTC), (True, JaxWav2Vec2ForCTC, Wav2Vec2ForCTC),
            (False, JaxWav2Vec2Model, Wav2Vec2Model)]
IDS = ["base_ctc", "robust_ctc", "base_backbone"]


@pytest.mark.parametrize("robust,jax_cls,port_cls", FAMILIES, ids=IDS)
def test_jax_save_pretrained_loads_bit_equal_into_the_port(tmp_path, robust, jax_cls, port_cls):
    cfg = tiny_config(robust=robust)
    jax_model = jax_cls(cfg, seed=3)
    jax_model.save_pretrained(str(tmp_path))
    model = port_cls.from_pretrained(str(tmp_path), device="cpu")
    assert model.config.is_robust == robust
    _assert_state_equals_tree(model.state_dict(), jax_model.params)
    speech = _speech(1)
    mask = np.ones_like(speech) if robust else None
    want = np.asarray(jax_model(speech, mask))
    with torch.no_grad():
        got = model(torch.from_numpy(speech),
                    None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=4e-3)


@pytest.mark.parametrize("robust,jax_cls,port_cls", FAMILIES, ids=IDS)
def test_port_save_pretrained_loads_bit_equal_into_jax(tmp_path, robust, jax_cls, port_cls):
    pcfg = port_config_of(tiny_config(robust=robust))
    model = port_cls(pcfg, device="cpu", generator=torch.Generator().manual_seed(4))
    model.save_pretrained(str(tmp_path))
    assert {p.name for p in tmp_path.iterdir()} == {"config.json", "jax_model.msgpack"}
    jax_model = jax_cls.from_pretrained(str(tmp_path))
    assert jax_model.config == tiny_config(robust=robust)
    _assert_state_equals_tree(model.state_dict(), jax_model.params)
    # and back into the port
    again = port_cls.from_pretrained(str(tmp_path), device="cpu")
    for name, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[name], t), name


@pytest.mark.parametrize("robust", [False, True])
def test_pretraining_tree_round_trips_with_flax(tmp_path, robust):
    """The JAX package has no pretraining model class: its tree goes through
    `flax.serialization` directly, beside the config's `save_pretrained`."""
    cfg = tiny_pretraining_config(robust=robust)
    params = jax_pretraining.init_wav2vec2_for_pretraining_params(jax.random.PRNGKey(5), cfg)
    cfg.save_pretrained(str(tmp_path))
    (tmp_path / "jax_model.msgpack").write_bytes(serialization.to_bytes(params))
    model = Wav2Vec2ForPreTraining.from_pretrained(str(tmp_path), device="cpu")
    assert type(model.config).__name__ == type(cfg).__name__
    assert model.config.num_negatives == cfg.num_negatives
    _assert_state_equals_tree(model.state_dict(), params)

    out = tmp_path / "port"
    model.save_pretrained(str(out))
    back = serialization.from_bytes(params, (out / "jax_model.msgpack").read_bytes())
    _assert_state_equals_tree(model.state_dict(), back)


def test_codec_writes_flax_bytes_and_reads_every_leaf_kind():
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": (np.arange(5, dtype=np.int32), {"s": np.float32(2.5), "b": np.bool_(True)}),
            "u8": np.arange(300, dtype=np.uint8), "f64": np.zeros((0, 2), np.float64),
            "py": {"i": 70000, "neg": -129, "f": 0.25, "s": "x" * 40, "none": None}}
    blob = serialization.to_bytes(tree)
    assert flax_msgpack.serialize(tree) == blob
    got = flax_msgpack.restore(blob)
    want = serialization.msgpack_restore(blob)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert type(a) is type(b) and np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_bfloat16_tree_both_ways(tmp_path):
    cfg = tiny_config()
    params = JaxWav2Vec2ForCTC(cfg, seed=7).params
    bf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    tree = flax_msgpack.restore(serialization.to_bytes(bf16))
    sd = params_from_jax(tree)
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    for name, t in params_from_jax(jax.tree_util.tree_map(
            lambda x: np.asarray(x).view(np.int16), bf16)).items():
        assert torch.equal(sd[name].view(torch.int16), t), name
    # bf16 state dict -> flax, bit for bit
    back = serialization.from_bytes(bf16, flax_msgpack.serialize(params_to_jax(sd)))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(bf16)):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a).view(np.int16), np.asarray(b).view(np.int16))
    # a bf16 file loads into the port's f32 parameters exactly
    cfg.save_pretrained(str(tmp_path))
    (tmp_path / "jax_model.msgpack").write_bytes(serialization.to_bytes(bf16))
    model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32 and torch.equal(t, sd[name].float()), name


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays over flax's MAX_CHUNK_SIZE are written as chunk maps; the limit
    is lowered in both libraries so that a small array is chunked."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(70, dtype=np.float32).reshape(7, 10), "b": np.ones(3, np.float32)}
    blob = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert flax_msgpack.serialize(tree) == blob
    got = flax_msgpack.restore(blob)
    np.testing.assert_array_equal(got["a"], tree["a"])
    back = serialization.msgpack_restore(flax_msgpack.serialize({"a": torch.arange(70.0).reshape(7, 10)}))
    np.testing.assert_array_equal(back["a"], tree["a"])


@pytest.mark.parametrize("blob", [b"\xc1", b"\x82\xa1a", b"\x81\xa1a\xc7\x02\x07xy", b"\x93\x01\x02"],
                         ids=["reserved_byte", "truncated", "unknown_ext", "not_a_map"])
def test_codec_refuses_what_it_cannot_read(blob):
    with pytest.raises(flax_msgpack.MsgpackError):
        flax_msgpack.restore(blob)


def _hf_state(cfg, seed):
    import transformers

    torch.manual_seed(seed)
    return transformers.Wav2Vec2ForCTC(matching_hf_config(cfg)).eval()


@requires_transformers
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_safetensors_from_the_safetensors_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    cfg = tiny_config()
    hf = _hf_state(cfg, seed=8)
    hf.config.save_pretrained(str(tmp_path))
    sd = {k: v.to(dtype).contiguous() for k, v in hf.state_dict().items()}
    save_file(sd, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    got = safetensors_io.load_file(str(tmp_path / "model.safetensors"))
    want = load_file(str(tmp_path / "model.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    if dtype == torch.float32:  # the JAX package reads safetensors through numpy, which has no bf16
        _assert_state_equals_tree(model.state_dict(), JaxWav2Vec2ForCTC.from_pretrained(str(tmp_path)).params)
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32 and torch.isfinite(t).all(), name


@requires_transformers
def test_safetensors_from_transformers_save_pretrained(tmp_path):
    hf = _hf_state(tiny_config(), seed=9)
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    assert (tmp_path / "model.safetensors").is_file()
    assert not (tmp_path / "pytorch_model.bin").exists()
    jax_model = JaxWav2Vec2ForCTC.from_pretrained(str(tmp_path))
    model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    _assert_state_equals_tree(model.state_dict(), jax_model.params)
    speech = _speech(2)
    with torch.no_grad():
        got = model(torch.from_numpy(speech)).numpy()
        hf_logits = hf(torch.from_numpy(speech)).logits.numpy()
    np.testing.assert_allclose(got, np.asarray(jax_model(speech)), atol=4e-3)
    np.testing.assert_allclose(got, hf_logits, atol=4e-3)


def test_msgpack_comes_before_torch_weights_and_config_kwargs_replace(tmp_path):
    cfg = tiny_config()
    jax_model = JaxWav2Vec2ForCTC(cfg, seed=10)
    jax_model.save_pretrained(str(tmp_path))
    decoy = Wav2Vec2ForCTC(port_config_of(cfg), device="cpu", generator=torch.Generator().manual_seed(1))
    torch.save(decoy.state_dict(), str(tmp_path / "pytorch_model.bin"))
    model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu", dropout=0.25,
                                           apply_spec_augment=False, input_shape=(1, 100))
    assert model.config.dropout == 0.25 and not model.config.apply_spec_augment
    assert dataclasses.replace(model.config, dropout=cfg.dropout,
                               apply_spec_augment=cfg.apply_spec_augment) == port_config_of(cfg)
    _assert_state_equals_tree(model.state_dict(), jax_model.params)


def test_h5_and_missing_weights_are_refused(tmp_path):
    """No weight file, or a tf_model.h5 that is not HDF5, raises."""
    port_config_of(tiny_config()).save_pretrained(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="No weights found"):
        Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    (tmp_path / "tf_model.h5").write_bytes(b"\x89HDF\r\n")
    with pytest.raises(OSError, match="file signature not found"):
        Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")


def test_h5_is_read(tmp_path):
    """A directory with config.json and the JAX package's tf_model.h5 (no
    msgpack) loads bit for bit."""
    jax_model = JaxWav2Vec2ForCTC(tiny_config(), seed=12)
    jax_model.save_pretrained(str(tmp_path), save_h5=True)
    (tmp_path / "jax_model.msgpack").unlink()
    model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    _assert_state_equals_tree(model.state_dict(), jax_model.params)


def test_remote_directory_round_trip_through_fsspec():
    import fsspec

    url = "memory://weights-test/model"
    try:
        model = Wav2Vec2ForCTC(port_config_of(tiny_config()), device="cpu",
                               generator=torch.Generator().manual_seed(11))
        model.save_pretrained(url)
        again = Wav2Vec2ForCTC.from_pretrained(url, device="cpu")
        for name, t in model.state_dict().items():
            assert torch.equal(again.state_dict()[name], t), name
        _assert_state_equals_tree(model.state_dict(), JaxWav2Vec2ForCTC.from_pretrained(url).params)
    finally:
        fsspec.filesystem("memory").rm("/weights-test", recursive=True)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Wav2Vec2ForCTC.from_pretrained("unused-directory")
