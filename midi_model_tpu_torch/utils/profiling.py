"""Profiling: the program's span-and-counter recorder and device traces.

Counterpart of ``midi_model_tpu/utils/profiling.py``.  ``trace()`` wraps
work in a ``torch.profiler`` capture (host operators, and CUDA kernels
where a card is present) and writes a Chrome trace under the directory it
is given.

The recorder times the program's own layers: the service, the batcher and
the training step call :func:`span` and :func:`count` at their
boundaries.  It is off by default, and then a call site costs one look at
the recorder's state and gets the shared :data:`NULL` span: no object is
made and nothing is recorded.  It is on

- inside ``with recording():`` (which :func:`trace` enters): every span
  is also entered as a ``torch.profiler.record_function`` of its name, so
  it shows on the profiler's timeline and in ``trace()``'s Chrome file;
- while a ``torch.profiler`` capture runs, whoever opened it: spans and
  counters are recorded in memory only, from an empty record at the
  capture's start (as :func:`on` first sees it).  A ``record_function``
  range also draws an annotation on the device's timeline, which a reader
  of that timeline would take for device work.

A span has a name, a start and an end on ``time.time_ns()`` (the clock
the profiler stamps its events on), its own id, its parent's id (the
innermost span open on the same thread, unless given), the native thread
id and a small dict of attributes; the spans of one request share its
``rid``.  Counters are named integer sums.  Both stay in memory, at most
:data:`MAX_SPANS` spans (those past it are counted under
:data:`DROPPED`), and :func:`snapshot` reads them out.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

MAX_SPANS = 1 << 18
DROPPED = "profiling.dropped_spans"

_depth = 0  # open ``recording()`` blocks
_captured = False  # a ``torch.profiler`` capture, as on() last saw it
_lock = threading.Lock()
_spans: List["Span"] = []
_counters: Dict[str, int] = defaultdict(int)
_ids = itertools.count(1)
_local = threading.local()


def _capturing() -> bool:
    """True while a ``torch.profiler`` capture runs (torch sets the flag
    on its start and clears it on its stop)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def sees_captures() -> bool:
    """True where this torch has the flag that :func:`on` reads to see a
    ``torch.profiler`` capture."""
    import torch.autograd.profiler as prof

    return hasattr(prof, "_is_profiler_enabled")


def on() -> bool:
    """True while the recorder records.  A capture that starts outside
    ``recording()`` starts from an empty record."""
    global _captured
    if _depth:
        return True
    capturing = _capturing()
    if capturing != _captured:
        with _lock:
            if capturing and not _captured and not _depth:
                _spans.clear()
                _counters.clear()
            _captured = capturing
    return capturing


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Optional[int]:
    """The id of the innermost span open on this thread, or None."""
    stack = _stack() if on() else None
    return stack[-1].id if stack else None


class Span:
    """One recorded span.  As a context manager it is this thread's
    innermost span from ``__enter__`` to ``__exit__``; not entered, it is
    ended by :meth:`finish`, from any thread."""

    __slots__ = ("name", "start", "end", "id", "parent", "thread", "attrs", "_range")

    def __init__(self, name: str, parent: Optional[int]):
        self.name = name
        self.id = next(_ids)
        self.parent = current() if parent is None else parent
        self.thread = threading.get_native_id()
        self.attrs: dict = {}
        self.end: Optional[int] = None
        self._range = None
        self.start = time.time_ns()

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        _stack().append(self)
        if _depth:
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.finish()

    def finish(self) -> None:
        """Stamp the end and keep the span (once)."""
        if self.end is not None:
            return
        self.end = time.time_ns()
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(self)
            else:
                _counters[DROPPED] += 1

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.start}..{self.end}, {self.attrs})")


class _Null:
    """What a call site gets while the recorder is off: falsy, and a
    context manager that does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def finish(self) -> None:
        return None


NULL = _Null()


def span(name: str, parent: Optional[int] = None, inherit: Tuple[str, ...] = ()):
    """While the recorder is on, a new :class:`Span` started now: ``with
    span("layer.part") as sp:`` records the block (set attributes under
    ``if sp:``); a span kept and ended by ``sp.finish()``, on any thread,
    records a wait that no block holds (a request in a queue, a thread's
    idle time), and is neither this thread's innermost span nor a
    ``record_function``.  ``inherit`` names attributes copied from the
    innermost span open on this thread.  :data:`NULL` while it is off."""
    if not on():
        return NULL
    sp = Span(name, parent)
    for outer in _stack()[-1:] if inherit else ():
        sp.attrs.update((k, outer.attrs[k]) for k in inherit if k in outer.attrs)
    return sp


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if not on():
        return
    with _lock:
        _counters[name] += int(n)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()


def snapshot() -> Tuple[List[Span], Dict[str, int]]:
    """(the finished spans in the order they ended, the counters)."""
    with _lock:
        return list(_spans), dict(_counters)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """``with recording(): ...`` turns the recorder on for the block; the
    outermost block starts from an empty record.  Read it with
    :func:`snapshot`, inside the block or after it."""
    global _depth
    with _lock:
        if _depth == 0:
            _spans.clear()
            _counters.clear()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``with trace("traces/"):`` — captures a ``torch.profiler`` trace when
    a directory is given and writes it there as
    ``trace_<pid>_<time ns>.json`` (Chrome trace format: chrome://tracing,
    Perfetto), with the program's spans on the host's timeline (the
    recorder is on inside); no-op when empty or None (so call sites need no
    branching)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
