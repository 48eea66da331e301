"""Full-state training checkpoints (counterpart of
`gsoc_wav2vec2_tpu/training/checkpoint.py`, whose Orbax needs JAX).

One directory per integer step, `<directory>/<step>/checkpoint.pt`, written
by `torch.save` under a temporary name and renamed into place, so a crash
never leaves half a checkpoint.  A checkpoint holds all a resumed run needs
to continue bit for bit:

  * `step`, the model's `state_dict`, the optimizer's `state_dict` (Adam's
    moments and step counts; its learning rate is the stage's), the names of
    the trainable parameters it was built over, the EMA shadow weights;
  * the state of the generator the step draws from (`TrainState.generator`)
    and of torch's default CPU and CUDA generators.

`restore` reads with `torch.load(weights_only=True)` into a `TrainState`
built over the same trainable set.

Under a `mesh` (`parallel.Mesh`) a checkpoint still holds whole tensors:
the split parameters, their Adam moments and EMA weights are gathered over
the model group, rank 0 writes and every rank waits at a barrier; a restore
slices each rank's shards back out.  So, as Orbax's are (JAX
`training/checkpoint.py`), checkpoints do not depend on the layout: one
written under (2, 1), (1, 2) or one process resumes under any other.

A `scheme://` directory (the reference's checkpoint bucket) goes through
fsspec, each file written whole under a temporary name and then moved.
"""

from __future__ import annotations

import io
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from ..data import remote
from ..parallel import multihost
from ..parallel.mesh import Mesh
from ..parallel.partition import shard_state_dict, shard_tensor, unshard_state_dict, unshard_tensor
from .state import TrainState, get_learning_rate

CHECKPOINT_FILE = "checkpoint.pt"


def _trainable_names(model) -> List[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _optimizer_state(sd: dict, names: List[str], convert, mesh: Optional[Mesh]) -> dict:
    """An optimizer `state_dict` (over parameters `names`) with each
    parameter's state tensors passed through `convert(name, tensor, mesh)`
    (gather or slice), in new dicts: `state_dict()` hands out the
    optimizer's own."""
    return {**sd, "state": {
        i: {key: (convert(names[i], t, mesh) if isinstance(t, torch.Tensor) and t.dim() else t)
            for key, t in per.items()}
        for i, per in sd["state"].items()}}


def _payload(state: TrainState, mesh: Optional[Mesh] = None) -> dict:
    """What `save` writes for `state`: CPU tensors and plain values only,
    whole tensors under a mesh (every rank of the mesh calls it)."""
    ema = state.ema_params
    return _cpu({
        "step": int(state.step),
        "model": unshard_state_dict(state.model.state_dict(), mesh),
        "trainable": _trainable_names(state.model),
        "optimizer": _optimizer_state(state.optimizer.state_dict(),
                                      _trainable_names(state.model), unshard_tensor, mesh),
        "learning_rate": float(get_learning_rate(state.optimizer)),
        "ema_params": None if ema is None else unshard_state_dict(ema, mesh),
        "generator": None if state.generator is None else state.generator.get_state(),
        "default_generators": {
            "cpu": torch.get_rng_state(),
            "cuda": torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else [],
        },
    })


class CheckpointManager:
    """Per-step full-state checkpoints under `directory`, keeping the newest
    `max_to_keep` (all when None); `mesh` as in the module docstring."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh
        self._remote = remote.is_remote_path(directory)
        if self._remote:
            self._fs, self._root = remote.fs_for(directory)
            self._fs.makedirs(self._root, exist_ok=True)
        else:
            self._root = os.path.abspath(directory)
            os.makedirs(self._root, exist_ok=True)
        self.directory = directory
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return f"{self._root.rstrip('/')}/{step}/{CHECKPOINT_FILE}"

    def all_steps(self) -> List[int]:
        if self._remote:
            names = [p.rstrip("/").rsplit("/", 1)[-1] for p in self._fs.ls(self._root, detail=False)]
            exists = self._fs.exists
        else:
            names = os.listdir(self._root)
            exists = os.path.isfile
        return sorted(int(n) for n in names
                      if re.fullmatch(r"\d+", n) and exists(self._path(int(n))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, wait: bool = False) -> None:
        """Write `state` as checkpoint `step` (replacing one of that step),
        then drop the oldest past `max_to_keep`.  Synchronous: `wait` is
        accepted for the JAX package's signature.  Under a mesh every rank
        calls it; rank 0 writes."""
        del wait
        payload = _payload(state, self.mesh)
        if multihost.rank() == 0:
            self._write(step, payload)
        multihost.barrier()

    def _write(self, step: int, payload: dict) -> None:
        if self._remote:
            buf = io.BytesIO()
            torch.save(payload, buf)
            final = self._path(step)
            tmp = f"{final}.tmp-{os.getpid()}"
            self._fs.pipe_file(tmp, buf.getvalue())
            self._fs.mv(tmp, final)
        else:
            tmp_dir = os.path.join(self._root, f".tmp-{step}-{os.getpid()}")
            os.makedirs(tmp_dir, exist_ok=True)
            torch.save(payload, os.path.join(tmp_dir, CHECKPOINT_FILE))
            final_dir = os.path.join(self._root, str(step))
            if os.path.isdir(final_dir):
                shutil.rmtree(final_dir)
            os.rename(tmp_dir, final_dir)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                self._delete(old)

    def _delete(self, step: int) -> None:
        path = f"{self._root.rstrip('/')}/{step}"
        if self._remote:
            self._fs.rm(path, recursive=True)
        else:
            shutil.rmtree(path)

    def restore_raw(self, step: Optional[int] = None) -> dict:
        """The saved payload of `step` (the latest when None) as CPU tensors
        and plain values, with no state to restore into (for averaging and
        inspection)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        path = self._path(step)
        src = io.BytesIO(self._fs.cat_file(path)) if self._remote else path
        return torch.load(src, map_location="cpu", weights_only=True)

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore checkpoint `step` (the latest when None) into `state_like`
        in place (model, optimizer, step, EMA, generators) and return it.  Its
        optimizer must have been built over the same trainable parameters.
        Under a mesh each rank takes its shards of the whole tensors."""
        ckpt = self.restore_raw(step)
        names = _trainable_names(state_like.model)
        if ckpt["trainable"] != names:
            raise ValueError(
                "the checkpoint's optimizer was built over other trainable parameters "
                f"({len(ckpt['trainable'])} saved, {len(names)} now)"
            )
        mesh = self.mesh
        state_like.model.load_state_dict(shard_state_dict(ckpt["model"], mesh), strict=True)
        state_like.optimizer.load_state_dict(
            _optimizer_state(ckpt["optimizer"], names, shard_tensor, mesh))
        state_like.step = int(ckpt["step"])
        if (ckpt["ema_params"] is None) != (state_like.ema_params is None):
            raise ValueError("the checkpoint and the state disagree on EMA weights")
        if state_like.ema_params is not None:
            ema = shard_state_dict(ckpt["ema_params"], mesh)
            with torch.no_grad():
                for name, t in state_like.ema_params.items():
                    t.copy_(ema[name])
        if state_like.generator is not None:
            if ckpt["generator"] is None:
                raise ValueError("the checkpoint holds no generator state")
            state_like.generator.set_state(ckpt["generator"])
        torch.set_rng_state(ckpt["default_generators"]["cpu"])
        if ckpt["default_generators"]["cuda"] and torch.cuda.is_available():
            torch.cuda.set_rng_state_all(ckpt["default_generators"]["cuda"])
        return state_like

    def wait_until_finished(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""

    def close(self) -> None:
        """Nothing is held open; kept for the JAX package's interface."""


def average_checkpoint_params(
    directory: str, steps: Optional[list] = None, last_n: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], List[int]]:
    """Mean of the model weights over several checkpoints (tail averaging):
    `steps` names them, `last_n` takes the newest N, default all.  Returns
    `(mean state dict, steps used)`: float tensors are summed in float64 in
    step order, divided, and cast back to their saved dtype; other tensors
    must agree across the checkpoints and pass through."""
    mgr = CheckpointManager(directory)
    available = mgr.all_steps()
    if not available:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if steps is not None:
        missing = sorted(set(steps) - set(available))
        if missing:
            raise ValueError(f"steps {missing} not in checkpoint dir {directory} "
                             f"(available: {available})")
        use = sorted(steps)
    elif last_n is not None:
        if last_n <= 0:
            raise ValueError("last_n must be positive")
        use = available[-last_n:]
    else:
        use = available

    acc: Dict[str, torch.Tensor] = {}
    dtypes: Dict[str, torch.dtype] = {}
    for step in use:
        for name, t in mgr.restore_raw(step)["model"].items():
            if name not in acc:
                dtypes[name] = t.dtype
                acc[name] = t.double() if t.is_floating_point() else t.clone()
            elif t.is_floating_point():
                acc[name] += t.double()
            elif not torch.equal(acc[name], t):
                raise ValueError(f"non-float param leaf {name} differs across checkpoints")
    mean = {name: (s / len(use)).to(dtypes[name]) if dtypes[name].is_floating_point else s
            for name, s in acc.items()}
    return mean, use
