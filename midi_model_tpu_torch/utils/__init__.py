"""Shared utilities: profiling, timing."""

from .profiling import StageTimer, trace

__all__ = ["StageTimer", "trace"]
