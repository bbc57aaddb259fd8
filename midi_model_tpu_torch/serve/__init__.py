"""Serving on the card: the continuous batcher and its streaming service,
the generation service behind the UI (``app``), audio rendering."""

from .app import (
    DRUM_KITS,
    GenerationRequest,
    KEY_SIGNATURES,
    MidiGenerationService,
    create_msg,
    send_msgs,
)
from .batcher import PREFILL_BUCKETS, ContinuousBatcher, Finished
from .batcher_service import BatcherService
from .synth import MidiSynthesizer, load_synthesizer

__all__ = [
    "BatcherService",
    "ContinuousBatcher",
    "DRUM_KITS",
    "Finished",
    "GenerationRequest",
    "KEY_SIGNATURES",
    "MidiGenerationService",
    "MidiSynthesizer",
    "PREFILL_BUCKETS",
    "create_msg",
    "load_synthesizer",
    "send_msgs",
]
