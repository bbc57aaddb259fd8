"""Config dataclasses, the Llama stack and the hierarchical MIDINet."""

from .config import CONFIG_NAMES, MIDIModelConfig, TransformerConfig

__all__ = ["CONFIG_NAMES", "MIDIModelConfig", "TransformerConfig"]
