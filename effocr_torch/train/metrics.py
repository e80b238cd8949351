"""Structured metrics logging (the JAX package's train/metrics.py): the
metric names train/loss, val/accuracy, written as JSONL to
``<run_dir>/metrics.jsonl``; a wandb sink attaches when asked for and
importable.  Inside a process group only the primary rank writes."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from effocr_torch.core import distributed


class MetricsWriter:
    def __init__(self, run_dir: str, use_wandb: bool = False,
                 project: str = "effocr_torch", name: Optional[str] = None):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._step = 0
        self._wandb = None
        self._f = None
        if not distributed.is_primary():
            return
        self._f = open(self.path, "a")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, name=name)
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if step is None:
            step = self._step
            self._step += 1
        if self._f is None:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
