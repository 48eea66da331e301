"""Per-layer rematerialisation (`modeling.encoder_forward(remat=...)`) on the
CPU, at the tiny config of tests/utils.py with the recipe's dropout 0.1,
SpecAugment and stochastic depth: `remat` False, "full" and "dots" give
bit-equal losses, gradients and parameters after one stage-2 step and after
one pretraining step (the layers' draws are taken before the first layer,
so a recomputed layer redraws nothing).  A `TorchDispatchMode` counts the
matrix products the backward runs: "dots" keeps every product of the
forward (its backward runs exactly no-remat's), "full" recomputes them.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.models import pretraining as pt
from gsoc_wav2vec2_tpu_torch.training import (
    create_optimizer,
    create_pretrain_optimizer,
    create_train_state,
    make_ctc_loss_fn,
    make_train_step,
    set_trainable,
)
from tests.utils import tiny_config, tiny_pretraining_config

torch.set_num_threads(2)

POLICIES = (False, "full", "dots")
REGULARISED = dict(dropout=0.1, apply_spec_augment=True, mask_time_prob=0.3, mask_time_length=4,
                   survival_prob=0.7)
SAMPLES = 8000
DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
        torch.ops.aten.baddbmm.default}


def _ctc_setup():
    jcfg = tiny_config(**REGULARISED)
    cfg = port_config.Wav2Vec2Config(**dataclasses.asdict(jcfg))
    model = modeling.Wav2Vec2ForCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    labels = np.zeros((2, 8), np.int64)
    labels[0, :5], labels[1, :3] = rng.integers(1, 32, 5), rng.integers(1, 32, 3)
    batch = {"speech": rng.standard_normal((2, SAMPLES)).astype(np.float32), "labels": labels}
    return cfg, model, batch


def _pretrain_setup():
    jcfg = tiny_pretraining_config(**REGULARISED)
    cfg = port_config.Wav2Vec2PretrainingConfig(**dataclasses.asdict(jcfg))
    model = pt.Wav2Vec2ForPreTraining(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(1)
    frames = int(cfg.conv_output_length(SAMPLES))
    mti = rng.random((2, frames)) < 0.5
    mti[:, :2] = True
    batch = {"speech": rng.standard_normal((2, SAMPLES)).astype(np.float32),
             "mask_time_indices": mti}
    return cfg, model, batch


def _ctc_step(remat):
    cfg, model, batch = _ctc_setup()
    set_trainable(model, ("feature_extractor",))
    state = create_train_state(model, create_optimizer(model, 1e-3))
    step = make_train_step(cfg, division_factor=2, remat=remat)
    state, metrics = step(state, batch, torch.Generator().manual_seed(5))
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return metrics["loss"], grads, model.state_dict()


def _pretrain_step(remat):
    cfg, model, batch = _pretrain_setup()
    set_trainable(model, ())
    state = create_train_state(model, create_pretrain_optimizer(model, 1e-3))
    step = pt.make_pretrain_step(cfg, division_factor=2, remat=remat)
    state, metrics = step(state, batch, torch.Generator().manual_seed(6), 1.5)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return metrics["loss"], grads, model.state_dict()


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("step", [_ctc_step, _pretrain_step], ids=["stage2", "pretrain"])
def test_remat_policies_give_bit_equal_steps(step):
    (loss0, grads0, params0), *others = [step(remat) for remat in POLICIES]
    assert torch.isfinite(loss0) and len(grads0) > 10
    for loss, grads, params in others:
        assert torch.equal(loss, loss0)
        assert _equal(grads, grads0)
        assert _equal(params, params0)


class _CountDots(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in DOTS
        return func(*args, **(kwargs or {}))


def _backward_dots(remat) -> int:
    cfg, model, batch = _ctc_setup()
    set_trainable(model, ("feature_extractor",))
    loss = make_ctc_loss_fn(cfg, division_factor=2, remat=remat)(
        model, batch, torch.Generator().manual_seed(5))
    with _CountDots() as counter:
        loss.backward()
    return counter.count


def test_dots_policy_recomputes_no_matrix_product():
    none, full, dots = (_backward_dots(r) for r in POLICIES)
    assert dots == none > 0
    # "full" recomputes each layer's 4 projections, 2 FFN and 2 attention products
    assert full == none + 8 * 2


def test_remat_rejects_unknown_policy():
    with pytest.raises(ValueError, match="remat"):
        modeling.remat_policy("offload")
    assert modeling.remat_policy(False) is None and modeling.remat_policy(True) is not None
