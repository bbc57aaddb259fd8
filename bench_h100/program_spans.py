"""The program's own spans and counters (``midi_model_tpu_torch.utils.
profiling``) in a traced run, and their joins with the device trace.

The program's recorder records while a ``torch.profiler`` capture runs,
from an empty record at the capture's start, so the traced window is
recorded without the harness asking; the readers take what it holds,
``profiling.snapshot()``.  A program without the recorder, or a run in
which it recorded no span, gives None, and the metric is left out; a
torch in which the recorder cannot see a capture fails the run.  Spans are
stamped on ``time.time_ns()``, the clock of the trace's window and device
intervals; a reader takes the spans that lie wholly in the window.  The
capture's stop after the window holds the program's threads for seconds,
so a span that the window's end cuts is stretched by it and is left out.
Counters carry no time: the recorder counts while the capture runs, which
is the window and its stop, when the program's threads are held.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from . import common
from .tracing import idle_gaps, union_ns


def recorded(run) -> Optional[Tuple[list, Dict[str, int]]]:
    """(spans, counters) that the program's recorder holds after a traced
    run; None for an untraced run, or a program without the recorder."""
    if getattr(run, "trace", None) is None:
        return None
    try:
        from midi_model_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "snapshot"):  # a program from before the recorder
        return None
    if not profiling.sees_captures():
        raise RuntimeError("this torch has no torch.autograd.profiler._is_profiler_enabled: "
                           "the program's recorder cannot see the traced window")
    spans, counters = profiling.snapshot()
    return (spans, counters) if spans else None


def in_window(spans, name: str, window) -> list:
    """The spans ``name`` that start and end in ``window``."""
    lo, hi = window
    return [s for s in spans if s.name == name and lo <= s.start and s.end <= hi]


def durations_ms(spans) -> List[float]:
    return [(s.end - s.start) / 1e6 for s in spans]


def p95_ms(run, name: str) -> Optional[float]:
    """The 95th percentile of the durations of the window's spans ``name``
    in ms; 0 where there are none."""
    rec = recorded(run)
    if rec is None:
        return None
    d = durations_ms(in_window(rec[0], name, run.trace.window))
    return common.quantile(d, 0.95) if d else 0.0


def ratio(num: float, den: float, scale: float = 1.0) -> float:
    """``scale * num / den``; 0 where the base is empty."""
    return scale * num / den if den else 0.0


def counter_ratio(run, num: str, den: str, scale: float = 1.0) -> Optional[float]:
    rec = recorded(run)
    if rec is None:
        return None
    counters = rec[1]
    return ratio(counters.get(num, 0), counters.get(den, 0), scale)


def merged(intervals) -> List[Tuple[int, int]]:
    """Sorted disjoint intervals covering ``intervals``."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_within_ns(trace, spans) -> int:
    """Device-idle time of the window that falls inside ``spans``."""
    gaps = idle_gaps([(s, e) for s, e, _, _ in trace.device], trace.window)
    covered = merged((s.start, s.end) for s in spans)
    starts = [s for s, _ in covered]
    total = 0
    for a, b in gaps:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(covered) and covered[i][0] < b:
            total += union_ns([covered[i]], (a, b))
            i += 1
    return total


def ops_launched_in(trace, spans) -> int:
    """Device operations whose launch (the host call with their correlation
    id) started inside one of ``spans``."""
    covered = merged((s.start, s.end) for s in spans)
    starts = [s for s, _ in covered]
    n = 0
    for _s, _e, _name, corr in trace.device:
        at = trace.launches.get(corr)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= covered[i][1]:
            n += 1
    return n
