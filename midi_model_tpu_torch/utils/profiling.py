"""Profiling helpers: device traces + host-side stage timing.

Counterpart of ``midi_model_tpu/utils/profiling.py``: ``trace()`` wraps
work in a ``torch.profiler`` capture (host operators, and CUDA kernels
where a card is present) and writes a Chrome trace under the directory it
is given; ``StageTimer`` is host-side per-stage wall-clock accounting with
a one-line report.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``with trace("traces/"):`` — captures a ``torch.profiler`` trace when
    a directory is given and writes it there as
    ``trace_<pid>_<time ns>.json`` (Chrome trace format: chrome://tracing,
    Perfetto); no-op when empty or None (so call sites need no branching)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulates wall-clock per named stage.

    with timer.stage("tokenize"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        parts = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            parts.append(f"{name}: {t:.3f}s/{n} ({1000 * t / max(n, 1):.2f} ms each)")
        return " | ".join(parts)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
