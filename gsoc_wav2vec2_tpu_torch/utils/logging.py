"""Metric logging: a JSONL file always, wandb when a project is named
(counterpart of `gsoc_wav2vec2_tpu/utils/logging.py`).

`wandb` is imported only when `project` is set; if it is not installed the
logger raises `ImportError` there and then, rather than log to the file
alone when the caller asked for wandb.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: str, project: Optional[str] = None, config=None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._wandb = None
        if project is not None:
            try:
                import wandb
            except ImportError as e:
                raise ImportError(
                    f"--wandb_project {project!r} needs the `wandb` package, which is "
                    "not installed; leave the project unset to log to metrics.jsonl only"
                ) from e
            self._wandb = wandb.init(project=project, config=config)
        self._file = open(self.path, "a")
        # without wandb a timestamp + nonce keys the run's checkpoint directory,
        # so that successive runs never collide (the reference keyed it on the
        # wandb run id, `main.py:272-274`)
        self._local_id = time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6]

    @property
    def run_id(self) -> str:
        return self._wandb.id if self._wandb is not None else self._local_id

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        record = {"ts": time.time(), **metrics}
        if step is not None:
            record["step"] = step
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """A `MetricLogger` that records nothing: what the ranks other than 0
    hold in a run of several processes (rank 0 logs for all of them)."""

    run_id = ""

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        del metrics, step

    def finish(self) -> None:
        pass
