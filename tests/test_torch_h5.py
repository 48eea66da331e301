"""The port's `tf_model.h5` reader and writer against the JAX package's, on
the CPU, without the reference's TF code.

The port writes (`save_pretrained(save_h5=True)`, `convert/torch_to_h5.py`)
and the JAX package's `load_h5_params` reads; the JAX package writes
(`save_h5_params`) and the port's `from_pretrained` reads
(`convert/h5_to_torch.py`): bit-equal parameters both ways, base and robust,
into the CTC model and into the bare backbone.  Then the refusals (a missing
variable, a wrong shape, the headless writer), `from_pretrained`'s file
order, an HF snapshot's HF-layout h5 that is never read, and a `memory://`
directory, which holds the msgpack only.
"""

import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_model import port_config_of
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu.convert.h5_to_jax import load_h5_params as jax_load_h5
from gsoc_wav2vec2_tpu.convert.jax_to_h5 import save_h5_params as jax_save_h5
from gsoc_wav2vec2_tpu.models.modeling import init_wav2vec2_for_ctc_params, init_wav2vec2_params
from gsoc_wav2vec2_tpu_torch.convert import h5_to_torch, torch_to_h5
from gsoc_wav2vec2_tpu_torch.convert.hf_torch import hf_name_map
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax, params_to_jax
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC, Wav2Vec2Model

torch.set_num_threads(2)

CASES = [(False, True), (False, False), (True, True), (True, False)]
IDS = ["base_ctc", "base_backbone", "robust_ctc", "robust_backbone"]


def _port_ctc(robust, seed):
    return Wav2Vec2ForCTC(port_config_of(tiny_config(robust=robust)), device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _assert_state_equals_tree(sd, tree):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert set(sd) == set(want)
    for name, t in want.items():
        assert sd[name].dtype == t.dtype, name
        assert torch.equal(sd[name], t), name


@pytest.mark.parametrize("robust,head", CASES, ids=IDS)
def test_port_h5_reads_bit_equal_in_jax(tmp_path, robust, head):
    model = _port_ctc(robust, seed=3)
    model.save_pretrained(str(tmp_path), save_h5=True)
    init = init_wav2vec2_for_ctc_params if head else init_wav2vec2_params
    template = init(jax.random.PRNGKey(0), tiny_config(robust=robust))
    params = jax_load_h5(str(tmp_path / "tf_model.h5"), template, with_lm_head=head)
    sd = model.state_dict()
    if not head:
        sd = {k.removeprefix("wav2vec2."): v for k, v in sd.items() if k.startswith("wav2vec2.")}
    _assert_state_equals_tree(sd, params)


@pytest.mark.parametrize("robust,head", CASES, ids=IDS)
def test_jax_h5_reads_bit_equal_in_the_port(tmp_path, robust, head):
    cfg = tiny_config(robust=robust)
    params = init_wav2vec2_for_ctc_params(jax.random.PRNGKey(5), cfg)
    cfg.save_pretrained(str(tmp_path))
    jax_save_h5(params, cfg, str(tmp_path / "tf_model.h5"))
    cls = Wav2Vec2ForCTC if head else Wav2Vec2Model
    model = cls.from_pretrained(str(tmp_path), device="cpu")
    _assert_state_equals_tree(model.state_dict(), params if head else params["wav2vec2"])


@pytest.mark.parametrize("robust", [False, True])
def test_h5_files_hold_the_same_variables_in_the_same_order(tmp_path, robust):
    """The port's writer and the JAX writer give the same groups, the same
    `weight_names` order (Keras matches by order) and equal datasets."""
    model = _port_ctc(robust, seed=4)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    params = params_to_jax(model.state_dict())
    torch_to_h5.save_h5_params(params, model.config, ours)
    jax_save_h5(params, tiny_config(robust=robust), theirs)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        for g in a:
            names = list(a[g].attrs["weight_names"])
            assert names == list(b[g].attrs["weight_names"]), g
            for n in names:
                np.testing.assert_array_equal(a[g][n][()], b[g][n][()])


def test_missing_variable_or_wrong_shape_raises(tmp_path):
    model = _port_ctc(False, seed=6)
    model.save_pretrained(str(tmp_path), save_h5=True)
    os.remove(tmp_path / "jax_model.msgpack")
    path = str(tmp_path / "tf_model.h5")
    template = params_to_jax(model.state_dict())

    def drop(part):
        with h5py.File(path, "a") as f:
            names = [n.decode() for n in f["wav2vec2"].attrs["weight_names"]]
            victim = next(n for n in names if part in n)
            del f["wav2vec2"][victim]
            f["wav2vec2"].attrs["weight_names"] = [n.encode() for n in names if n != victim]

    drop("feature_projection/projection/kernel")
    with pytest.raises(KeyError, match="missing variables"):
        Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(KeyError, match="feature_projection/projection/kernel"):
        h5_to_torch.load_h5_params(path, template)
    # one layer's variable gone: that layer stack is short, as in the JAX reader
    model.save_pretrained(str(tmp_path), save_h5=True)
    os.remove(tmp_path / "jax_model.msgpack")
    drop("layers/0/attention/q_proj/kernel")
    with pytest.raises((KeyError, ValueError)):
        Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    model.save_pretrained(str(tmp_path), save_h5=True)
    with h5py.File(path, "a") as f:
        name = "wav2vec2-ctc/lm_head/bias:0"
        del f["lm_head"][name]
        f["lm_head"].create_dataset(name, data=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="Shape mismatch for lm_head/bias"):
        h5_to_torch.load_h5_params(path, template)


def test_headless_and_projectionless_writes_are_refused(tmp_path):
    backbone = Wav2Vec2Model(port_config_of(tiny_config()), device="cpu")
    with pytest.raises(NotImplementedError, match="Wav2Vec2ForCTC only"):
        backbone.save_pretrained(str(tmp_path), save_h5=True)
    model = Wav2Vec2ForCTC(port_config_of(tiny_config(feat_proj_layer_norm=False)), device="cpu")
    with pytest.raises(ValueError, match="feat_proj_layer_norm"):
        model.save_pretrained(str(tmp_path), save_h5=True)


def test_from_pretrained_file_order(tmp_path):
    """msgpack before h5, h5 before the torch weights (the JAX package's
    order)."""
    a, b, c = (_port_ctc(False, seed=s) for s in (7, 8, 9))
    a.save_pretrained(str(tmp_path))
    os.rename(tmp_path / "jax_model.msgpack", tmp_path / "a.msgpack")
    b.save_pretrained(str(tmp_path), save_h5=True)
    os.remove(tmp_path / "jax_model.msgpack")
    torch.save(c.state_dict(), str(tmp_path / "pytorch_model.bin"))

    def loaded():
        return Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu").state_dict()

    def equal(sd, model):
        return all(torch.equal(sd[k], v) for k, v in model.state_dict().items())

    assert equal(loaded(), b)  # h5 before pytorch_model.bin
    os.rename(tmp_path / "a.msgpack", tmp_path / "jax_model.msgpack")
    assert equal(loaded(), a)  # msgpack before h5
    os.remove(tmp_path / "jax_model.msgpack")
    os.remove(tmp_path / "tf_model.h5")
    # pytorch_model.bin holds the port's own names here: the HF map finds none of
    # them under HF names, so the load must fail rather than keep the seed's weights
    with pytest.raises(RuntimeError, match="Missing key"):
        loaded()


def test_hf_snapshot_never_reads_its_h5(tmp_path):
    """An HF-schema snapshot's tf_model.h5 is the TF `transformers` layout:
    the torch weights load and the (undecodable) h5 is not opened."""
    hf = {"model_type": "wav2vec2", "vocab_size": 32, "hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "intermediate_size": 128, "conv_dim": [32] * 7,
          "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
          "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16}
    model = _port_ctc(False, seed=10)
    sd = model.state_dict()
    names = hf_name_map(model.config, with_lm_head=True, prefix="wav2vec2.")
    torch.save({theirs: fn(sd[ours]) for ours, (theirs, fn) in names.items() if ours in sd},
               str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps(hf))
    (tmp_path / "tf_model.h5").write_bytes(b"\x89HDF-not-really")
    loaded = Wav2Vec2ForCTC.from_pretrained(str(tmp_path), device="cpu")
    for k, v in sd.items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_remote_directory_holds_the_msgpack_only():
    """A `scheme://` directory is read for its msgpack alone: one with only
    a tf_model.h5 fails on the missing msgpack; `save_h5=True` writes the h5
    there through fsspec all the same."""
    import fsspec

    fs = fsspec.filesystem("memory")
    try:
        model = _port_ctc(False, seed=11)
        model.save_pretrained("memory://h5test/full", save_h5=True)
        assert fs.exists("/h5test/full/tf_model.h5")
        with fs.open("/h5test/h5only/config.json", "wb") as f:
            f.write(fs.cat("/h5test/full/config.json"))
        with fs.open("/h5test/h5only/tf_model.h5", "wb") as f:
            f.write(fs.cat("/h5test/full/tf_model.h5"))
        with pytest.raises(FileNotFoundError):
            Wav2Vec2ForCTC.from_pretrained("memory://h5test/h5only", device="cpu")
    finally:
        fs.rm("/h5test", recursive=True)
