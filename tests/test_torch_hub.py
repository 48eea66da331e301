"""Hub and remote paths of the port, offline (`tests/test_hub_paths.py`'s
cases): `from_pretrained(model_id)` downloads through
`huggingface_hub.snapshot_download`, `push_to_hub`, and a `memory://`
directory.  A fake `huggingface_hub` module stands in `sys.modules`, so no
test reaches the network; the JAX package reads what the port writes."""

import sys
import types

import fsspec
import numpy as np
import pytest
import torch

from tests.test_torch_model import port_config_of
from tests.utils import tiny_config

from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC

torch.set_num_threads(2)


@pytest.fixture()
def tiny_saved(tmp_path):
    model = Wav2Vec2ForCTC(port_config_of(tiny_config()), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    d = str(tmp_path / "saved")
    model.save_pretrained(d)
    return d, model


def _fake_hub(monkeypatch, **attrs):
    hub = types.ModuleType("huggingface_hub")
    for k, v in attrs.items():
        setattr(hub, k, v)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    return hub


def test_from_pretrained_model_id_downloads_via_hub(tiny_saved, monkeypatch):
    """A model id that is not a local directory goes through
    snapshot_download (flax weights skipped) and loads what it returns."""
    d, model = tiny_saved
    calls = []

    def snapshot_download(model_id, **kwargs):
        calls.append((model_id, kwargs))
        return d

    _fake_hub(monkeypatch, snapshot_download=snapshot_download)
    loaded = Wav2Vec2ForCTC.from_pretrained("someone/wav2vec2-tiny", device="cpu")
    assert calls == [("someone/wav2vec2-tiny", {"ignore_patterns": ["flax_model*"]})]
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_from_pretrained_download_failure_is_actionable(monkeypatch):
    def snapshot_download(model_id, **kwargs):
        raise OSError("offline")

    _fake_hub(monkeypatch, snapshot_download=snapshot_download)
    with pytest.raises(ValueError, match="not a local directory.*offline"):
        Wav2Vec2ForCTC.from_pretrained("someone/missing-model", device="cpu")
    # without the package at all: the same actionable error
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ValueError, match="Pass a local path"):
        Wav2Vec2ForCTC.from_pretrained("someone/missing-model", device="cpu")


def test_push_to_hub_creates_repo_and_uploads(tiny_saved, monkeypatch):
    d, model = tiny_saved
    events = []

    class FakeApi:
        def create_repo(self, model_id, exist_ok=False):
            events.append(("create", model_id, exist_ok))

        def upload_folder(self, folder_path=None, repo_id=None):
            events.append(("upload", folder_path, repo_id))
            return f"https://hub/{repo_id}"

    _fake_hub(monkeypatch, HfApi=FakeApi)
    url = model.push_to_hub(d, "someone/wav2vec2-tiny")
    assert events == [("create", "someone/wav2vec2-tiny", True),
                      ("upload", d, "someone/wav2vec2-tiny")]
    assert url.endswith("someone/wav2vec2-tiny")


def test_push_to_hub_without_hub_package_raises_importerror(tiny_saved, monkeypatch):
    d, model = tiny_saved
    _fake_hub(monkeypatch)  # a module without HfApi: the import inside fails
    with pytest.raises(ImportError, match="huggingface_hub"):
        model.push_to_hub(d, "someone/x")


@pytest.fixture()
def memfs():
    fs = fsspec.filesystem("memory")
    yield fs
    for path in list(fs.store):
        try:
            fs.rm(path)
        except FileNotFoundError:
            pass


def test_from_remote_roundtrip(tiny_saved, memfs):
    """save_pretrained to an object store and back; the JAX package reads
    the same directory; config kwargs replace() there too."""
    _, model = tiny_saved
    model.save_pretrained("memory://hubtest/tiny")
    loaded = Wav2Vec2ForCTC.from_pretrained("memory://hubtest/tiny", device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    np.testing.assert_array_equal(
        np.asarray(JaxWav2Vec2ForCTC.from_pretrained("memory://hubtest/tiny").params["lm_head"]["kernel"]),
        model.lm_head.kernel.numpy())
    hot = Wav2Vec2ForCTC.from_pretrained("memory://hubtest/tiny", device="cpu", dropout=0.3)
    assert hot.config.dropout == 0.3


def test_from_remote_refuses_h5_fallback(tiny_saved, memfs):
    """A bucket holding only tf_model.h5 fails on the missing msgpack and
    never reaches the hub."""
    d, _ = tiny_saved
    with open(f"{d}/config.json", "rb") as f:
        cfg_bytes = f.read()
    with memfs.open("/hubtest/h5only/config.json", "wb") as f:
        f.write(cfg_bytes)
    with memfs.open("/hubtest/h5only/tf_model.h5", "wb") as f:
        f.write(b"not-actually-h5")
    with pytest.raises(FileNotFoundError):
        Wav2Vec2ForCTC.from_pretrained("memory://hubtest/h5only", device="cpu")
