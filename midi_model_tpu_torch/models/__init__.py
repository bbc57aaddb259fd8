"""Config dataclasses, the Llama stack, the hierarchical MIDINet, LoRA and
the ``MIDIModel`` facade."""

from .config import CONFIG_NAMES, MIDIModelConfig, TransformerConfig
from .api import MIDIModel

__all__ = ["CONFIG_NAMES", "MIDIModel", "MIDIModelConfig", "TransformerConfig"]
