"""The training CLIs hold cuDNN to deterministic algorithms before they build a model.

In f32 the pos conv is cuDNN's grouped conv, whose default backward
algorithms may sum in a different order from run to run; a resumed run is
then not the straight run bit for bit.  `cli.train.main` and
`cli.pretrain.main` call `training.deterministic_training` as they start;
here each is stopped at its next step (building the model, reading the
data), with cuDNN's flags set the other way first.  The card test
`tests/test_torch_cuda.py::test_f32_robust_steps_are_bit_equal_under_the_cli_settings`
holds two f32 steps bit-equal under those settings.
"""

import pytest
import torch

from gsoc_wav2vec2_tpu_torch import training
from gsoc_wav2vec2_tpu_torch.cli import pretrain, train

torch.set_num_threads(2)


class _Started(Exception):
    pass


@pytest.fixture
def cudnn_flags():
    """cuDNN's flags set against determinism, restored after the test."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _recorded(monkeypatch, module, calls):
    real = module.deterministic_training

    def recording():
        calls.append(module.__name__)
        real()

    monkeypatch.setattr(module, "deterministic_training", recording)


def test_deterministic_training_sets_cudnn_flags(cudnn_flags):
    training.deterministic_training()
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_cli_sets_determinism_before_building_the_model(cudnn_flags, monkeypatch, dtype):
    calls = []
    _recorded(monkeypatch, train, calls)

    def build(args, device):
        assert calls == [train.__name__]
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        raise _Started

    monkeypatch.setattr(train, "_build_model", build)
    with pytest.raises(_Started):
        train.main(train.TrainingArgs(device="cpu", compute_dtype=dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pretrain_cli_sets_determinism_before_reading_data(cudnn_flags, monkeypatch, dtype):
    calls = []
    _recorded(monkeypatch, pretrain, calls)

    def loader(*a, **kw):
        assert calls == [pretrain.__name__]
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        raise _Started

    monkeypatch.setattr(pretrain, "LibriSpeechDataLoader", loader)
    with pytest.raises(_Started):
        pretrain.main(pretrain.PretrainingArgs(device="cpu", compute_dtype=dtype,
                                               train_dir="unread"))
