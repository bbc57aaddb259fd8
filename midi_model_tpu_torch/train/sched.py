"""Learning-rate schedule: linear warmup then linear decay to zero.

Counterpart of ``midi_model_tpu/train/sched.py``, in float32 like it.
"""

from __future__ import annotations

import numpy as np


def linear_warmup_decay(base_lr: float, warmup_steps: int, total_steps: int):
    """Returns ``schedule(step) -> float``: ``base_lr * step / warmup`` before
    ``warmup_steps``, then a linear decay that reaches 0 at ``total_steps``."""

    def schedule(step) -> float:
        step = np.float32(step)
        warm = step / np.float32(max(1.0, warmup_steps))
        decay = np.maximum(np.float32(0.0), (np.float32(total_steps) - step)
                           / np.float32(max(1.0, total_steps - warmup_steps)))
        return float(np.float32(base_lr) * (warm if step < warmup_steps else decay))

    return schedule
