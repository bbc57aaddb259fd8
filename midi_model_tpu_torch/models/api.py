"""Drop-in object API: the reference's ``MIDIModel`` surface on the port.

Counterpart of ``midi_model_tpu/models/api.py``.  Users write
``MIDIModel.from_pretrained(path)``, ``model.generate(...)``,
``model.forward(...)``; the functional core (``models.midinet``,
``sampling.generate``) stays the real API, and this class bundles the
model, its config and tokenizer, with checkpoint loading and LoRA merging
attached.  It builds on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .config import CONFIG_NAMES, MIDIModelConfig
from .midinet import MIDINet, init_model, param_count


class MIDIModel:
    """Hierarchical MIDI transformer: model + config + tokenizer in one box.

    ``model``: a :class:`MIDINet`; None makes one with random weights from
    ``seed`` in ``dtype`` (default bf16, as the JAX class) on ``device``
    (None: the card)."""

    def __init__(self, config: Optional[MIDIModelConfig] = None,
                 model: Optional[MIDINet] = None, dtype=None, seed: int = 0, device=None):
        self.config = config or MIDIModelConfig.from_name("tv2o-medium")
        self.tokenizer = self.config.tokenizer
        if model is None:
            model = init_model(self.config, seed=seed, dtype=dtype or torch.bfloat16,
                               device=device)
        self.model = model

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ---- constructors ----------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str, config=None, dtype=None, device=None) -> "MIDIModel":
        """Load a checkpoint: a directory holding ``model.safetensors``, or a
        ``.safetensors`` / ``.bin`` / ``.ckpt`` file.  The config comes from
        the ``config.json`` beside it unless given (a config, a config name
        or a config.json path).  Weights in ``dtype`` (default bf16) on
        ``device`` (None: the card)."""
        from ..interop import load_state_dict, params_from_state_dict

        if config is None:
            base = path if os.path.isdir(path) else os.path.dirname(path)
            config = MIDIModelConfig.from_json_file(os.path.join(base, "config.json"))
        elif isinstance(config, str):
            config = (MIDIModelConfig.from_name(config) if config in CONFIG_NAMES
                      else MIDIModelConfig.from_json_file(config))
        if os.path.isdir(path):
            path = os.path.join(path, "model.safetensors")
        model = params_from_state_dict(load_state_dict(path), config,
                                       dtype=dtype or torch.bfloat16, device=device)
        return cls(config, model)

    def save_pretrained(self, out_dir: str):
        """Write ``config.json`` and an f32 ``model.safetensors`` (the
        reference's layout, loadable by the JAX package and by torch)."""
        from ..interop import save_file, state_dict_from_params

        os.makedirs(out_dir, exist_ok=True)
        self.config.save_pretrained(out_dir)
        save_file(state_dict_from_params(self.model), os.path.join(out_dir, "model.safetensors"))

    def load_merge_lora(self, adapter_path: str, alpha: float = 128.0) -> "MIDIModel":
        """Merge a peft adapter (a directory holding
        ``adapter_model.safetensors``, or the file) into the weights."""
        from .lora import load_peft_adapter, merge_lora

        if os.path.isdir(adapter_path):
            adapter_path = os.path.join(adapter_path, "adapter_model.safetensors")
        lora = load_peft_adapter(adapter_path, self.config)
        params = dict(self.model.named_parameters())
        merged = merge_lora(params, lora, alpha=alpha)
        with torch.no_grad():
            for name, w in params.items():
                if merged[name] is not w:
                    w.copy_(merged[name])
        return self

    # ---- compute ---------------------------------------------------------

    def _tensor(self, x):
        return None if x is None else torch.as_tensor(x, device=self.device)

    def forward(self, x, cache=None):
        """x [B, L, T] token ids -> (event hidden [B, L, D], cache)."""
        with torch.no_grad():
            return self.model(self._tensor(x), cache)

    def forward_token(self, hidden_state=None, x=None, cache=None):
        """hidden_state [B, D] and/or x [B, T] -> (logits [B, S, V], cache)."""
        with torch.no_grad():
            return self.model.forward_token(self._tensor(hidden_state), self._tensor(x),
                                            cache)

    def generate(self, prompt=None, batch_size: int = 1, max_len: int = 512,
                 temp: float = 1.0, top_p: float = 0.98, top_k: int = 20,
                 seed: int = 0, **kwargs) -> np.ndarray:
        """Batched grammar-constrained sampling (``sampling.generate``, every
        keyword passed on: ``greedy``, ``kv_int8``, ``fused``, ...)."""
        from ..sampling import generate as gen

        return gen(self.model, self.config, prompt=prompt, batch_size=batch_size,
                   max_len=max_len, temp=temp, top_p=top_p, top_k=top_k, seed=seed, **kwargs)

    def param_count(self) -> int:
        return param_count(self.model)
