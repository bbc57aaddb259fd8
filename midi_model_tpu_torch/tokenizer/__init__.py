"""Event tokenizers (host-side) + vocab tables for on-device decoding.

The port's own copy of ``midi_model_tpu/tokenizer/`` (the port imports
nothing of the JAX package); held equal to it by
``tests/test_torch_tokenizer.py``.  Tokenizing takes the port's C++ scan
(``midi_model_tpu_torch.native``) where it builds, the Python scan
otherwise; both give the same rows."""

from .base import EventTokenizerBase
from .v1 import MIDITokenizerV1
from .v2 import MIDITokenizerV2
from .vocab import Vocab


def MIDITokenizer(version: str = "v2"):
    """Factory matching the reference's entry point
    (midi_tokenizer.py:1189-1196)."""
    if version == "v1":
        return MIDITokenizerV1()
    if version == "v2":
        return MIDITokenizerV2()
    raise ValueError(f"Unsupported version: {version}")


__all__ = [
    "EventTokenizerBase",
    "MIDITokenizer",
    "MIDITokenizerV1",
    "MIDITokenizerV2",
    "Vocab",
]
