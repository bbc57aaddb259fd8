"""Training metrics: a TensorBoard writer where one is installed, and a
JSONL mirror that is always written.

Counterpart of ``midi_model_tpu/train/metrics.py``.  Metric names match the
reference's logs (``train/loss``, ``train/lr``, ``val/loss``, ``val/acc``);
the mirror makes headless runs greppable.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        if importlib.util.find_spec("tensorboard") is not None:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float]):
        if self._tb is not None:
            for name, value in metrics.items():
                self._tb.add_scalar(name, value, step)
        rec = {"step": step, "time": time.time(), **metrics}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
