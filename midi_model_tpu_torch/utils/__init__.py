"""Shared utilities: the span-and-counter recorder, device traces."""

from .profiling import recording, snapshot, span, trace

__all__ = ["recording", "snapshot", "span", "trace"]
