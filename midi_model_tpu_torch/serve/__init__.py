"""Continuous-batch serving on the card: the batcher and its service."""

from .batcher import PREFILL_BUCKETS, ContinuousBatcher, Finished
from .batcher_service import BatcherService

__all__ = ["BatcherService", "ContinuousBatcher", "Finished", "PREFILL_BUCKETS"]
