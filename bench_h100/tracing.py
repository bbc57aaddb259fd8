"""The traced run: ``torch.profiler`` over the measured window, the
benchmark's own ranges, and their reduction.

- busy time is the union of the device's operation intervals inside the
  window (overlapping operations count once); idle is the rest;
- a range is a span the benchmark opens around a call into the program
  (:meth:`Tracer.span`; names start with ``bench.``), timed by the host's
  clock (the profiler's own clock) and shown in the profiler's timeline;
- a device operation belongs to a range when the host call that launched
  it (the CUDA runtime or driver call with its correlation id) started
  inside the range.  The service's lock keeps a step and a submission
  apart, so a range is not shared with another thread's launches;
- the breakdown lists the device operations that took most time and the
  longest idle gaps, each gap named by the innermost benchmark range open
  at its middle, or by the host's last operation before it.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

RANGE_PREFIX = "bench."
# host calls that put work on the device (CUDA runtime and driver API)
LAUNCH_PREFIXES = ("cuda", "cu")


@dataclass
class TraceSummary:
    window: Tuple[int, int]  # ns, the host's (and the profiler's) clock
    device: List[Tuple[int, int, str, int]]  # (start, end, name, launch correlation)
    ranges: List[Tuple[int, int, str, int]]  # (start, end, name, thread)
    launches: Dict[int, int]  # correlation -> host start
    host_ops: List[Tuple[int, int, str]] = field(default_factory=list)  # sorted by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return union_ns([(s, e) for s, e, _, _ in self.device], self.window) / 1e9

    def device_s(self, names) -> float:
        """Device seconds of the operations whose name holds one of ``names``."""
        return sum(e - s for s, e, n, _ in self.device if any(x in n for x in names)) / 1e9

    def device_s_in_ranges(self, name: str) -> float:
        """Device seconds of the operations launched inside the ranges ``name``."""
        spans = sorted((s, e) for s, e, n, _ in self.ranges if n == name)
        starts = [s for s, _ in spans]
        total = 0
        for s, e, _, corr in self.device:
            at = self.launches.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += e - s
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(int)
        for s, e, n, _ in self.device:
            ops[n[:120]] += e - s
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps([(s, e) for s, e, _, _ in self.device], self.window)
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        named = [[self.host_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:top]]
        return {"device_ops": [[n, t / 1e9] for n, t in device_ops], "idle_gaps": named}

    def host_at(self, t: int) -> str:
        inner = None
        for r in self.ranges:
            if r[0] <= t <= r[1] and (inner is None or r[1] - r[0] < inner[1] - inner[0]):
                inner = r
        if inner is not None:
            return inner[2]
        at = bisect.bisect_right(self.host_ops, (t, float("inf"))) - 1
        return f"host: {self.host_ops[at][2][:80]}" if at >= 0 else "host"


def union_ns(spans, window) -> int:
    lo, hi = window
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans, window) -> List[Tuple[int, int]]:
    lo, hi = window
    gaps, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


class Tracer:
    """``with tracer.window():`` profiles the measured window and
    ``tracer.span(name)`` times a call into the program; afterwards
    ``summary()`` reduces them.  Without ``enabled`` both do nothing."""

    def __init__(self, enabled: bool, all_threads: bool = False):
        self.enabled = enabled
        self.all_threads = all_threads
        self.prof = None
        self._window = None
        self._spans: List[Tuple[int, int, str, int]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        t0 = time.time_ns()
        try:
            with record_function(RANGE_PREFIX + name):
                yield
        finally:
            with self._lock:
                self._spans.append((t0, time.time_ns(), RANGE_PREFIX + name,
                                    threading.get_native_id()))

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self.prof = None
        if self.all_threads:
            try:  # every thread's host operations, where this torch can
                from torch._C._profiler import _ExperimentalConfig

                self.prof = profile(activities=activities, experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            except (ImportError, TypeError):
                pass
        if self.prof is None:
            self.prof = profile(activities=activities)
        self.prof.__enter__()
        t0 = time.time_ns()
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t1 = time.time_ns()
            self.prof.__exit__(None, None, None)
            self._window = (t0, t1)
            print(f"trace: the capture stopped in {(time.time_ns() - t1) / 1e9:.3f} s",
                  file=sys.stderr)

    def summary(self) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        device, launches, host = [], {}, []
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                if name.startswith(RANGE_PREFIX):  # a range's image on the device's timeline
                    continue
                device.append((s, e, name, ev.correlation_id(), ev.linked_correlation_id()))
            elif name.startswith(LAUNCH_PREFIXES):
                launches[ev.correlation_id()] = s
            elif not name.startswith(RANGE_PREFIX):
                host.append((s, e, name))
        # a device operation's launch: its own correlation id, or its link
        device = [(s, e, n, c if c in launches else lc) for s, e, n, c, lc in device]
        matched = sum(1 for d in device if d[3] in launches)
        print(f"trace: {len(device)} device operations ({matched} with their launch), "
              f"{len(self._spans)} benchmark ranges, {len(host)} host operations",
              file=sys.stderr)
        self.prof = None
        host.sort()
        return TraceSummary(self._window, device, list(self._spans), launches, host)
