"""LoRA as a transform of the model's named weights.

Counterpart of ``midi_model_tpu/models/lora.py``.  The port's weights are
per layer, in torch's ``[out, in]`` layout (``net.layers.{i}.self_attn.
q_proj.weight``), so one adapter is peft's own pair for one matrix:
``A [r, in]`` and ``B [out, r]``, with ``ΔW = (α/r)·B@A``.

An adapter set is a flat dict keyed like peft's state dict without its
``base_model.model.`` prefix — ``net.layers.0.self_attn.q_proj.lora_A.weight``
and ``...lora_B.weight`` — so the trainer's optimizer and checkpoints take
it as they take the weights.

- :func:`apply_lora` / :func:`merge_lora`: the effective weights
  ``W + (α/r)·B@A``, summed in f32 and cast back to W's dtype (no mutation;
  differentiable in A and B);
- :func:`peft_state_dict_to_lora` / :func:`lora_to_peft_state_dict` and
  :func:`load_peft_adapter`: peft's ``adapter_model.safetensors`` layout,
  read through the port's own ``interop.safetensors_io``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .config import MIDIModelConfig, require_llama

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# the JAX package's stacked name -> peft module name
_PEFT_NAMES = {
    "wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}
_PEFT_PREFIX = "base_model.model."
_KEY = re.compile(r"(?:base_model\.model\.)?((?:net|net_token)\.layers\.\d+\.(.+?))"
                  r"\.lora_(A|B)\.(?:default\.)?weight")

Params = Dict[str, torch.Tensor]


def _adapter_keys(module: str):
    """The A and B keys of the adapter of ``module`` (e.g.
    ``net.layers.0.self_attn.q_proj``)."""
    return f"{module}.lora_A.weight", f"{module}.lora_B.weight"


def init_lora(params: Params, generator: torch.Generator, rank: int = 64) -> Params:
    """f32 adapters for every ``DEFAULT_TARGETS`` matrix of both nets, on the
    weights' device: ``A ~ N(0, 1) / sqrt(in)`` drawn from ``generator``
    (which must live on that device), ``B = 0`` (peft's convention: ΔW
    starts at 0).  ``params`` maps the model's parameter names to its
    weights."""
    modules = {_PEFT_NAMES[t] for t in DEFAULT_TARGETS}
    lora = {}
    for name, w in params.items():
        module = name[:-len(".weight")]
        if ".layers." not in name or module.split(".", 3)[3] not in modules:
            continue
        d_out, d_in = w.shape
        a_key, b_key = _adapter_keys(module)
        lora[a_key] = torch.randn((rank, d_in), generator=generator, device=w.device) / np.sqrt(d_in)
        lora[b_key] = torch.zeros((d_out, rank), device=w.device)
    return lora


def apply_lora(params: Params, lora: Params, alpha: float = 128.0) -> Params:
    """The effective weights ``W + (α/r)·B@A`` for every adapted matrix, the
    other weights as they are; a new dict, ``params`` untouched.  The sum is
    in f32 and cast back to W's dtype; ``r`` is A's first axis."""
    out = dict(params)
    for key, a in lora.items():
        if not key.endswith(".lora_A.weight"):
            continue
        module = key[:-len(".lora_A.weight")]
        b = lora[_adapter_keys(module)[1]]
        name = f"{module}.weight"
        w = params[name]
        scale = alpha / a.shape[0]
        delta = (b.to(w.device, torch.float32) @ a.to(w.device, torch.float32)) * scale
        out[name] = (w.float() + delta).to(w.dtype)
    return out


def merge_lora(params: Params, lora: Params, alpha: float = 128.0) -> Params:
    """Alias of :func:`apply_lora`: merging is the application for inference."""
    return apply_lora(params, lora, alpha)


def load_peft_adapter(path: str, config: MIDIModelConfig) -> Params:
    """A peft ``adapter_model.safetensors`` as an adapter set (CPU, f32)."""
    from ..interop.safetensors_io import load_file

    return peft_state_dict_to_lora(load_file(path), config)


def peft_state_dict_to_lora(sd: Dict[str, np.ndarray], config: MIDIModelConfig) -> Params:
    """peft's keys (with or without the ``base_model.model.`` prefix and the
    ``default`` adapter name) -> an adapter set; keys of other modules are
    ignored.  Every adapted module must have both factors, for every layer
    of its net.  A hybrid event net takes no adapters."""
    require_llama(config, "LoRA")
    lora: Params = {}
    modules = set(_PEFT_NAMES.values())
    layers: Dict[tuple, set] = {}
    for key, val in sd.items():
        m = _KEY.fullmatch(key)
        if not m or m.group(2) not in modules:
            continue
        module, ab = m.group(1), m.group(3)
        lora[f"{module}.lora_{ab}.weight"] = torch.tensor(np.asarray(val, np.float32))
        net, _, i = module.split(".", 3)[:3]
        layers.setdefault((net, m.group(2)), set()).add(int(i))
    for (net, module), found in layers.items():
        n_layers = (config.net if net == "net" else config.net_token).num_layers
        if found != set(range(n_layers)):
            raise KeyError(f"adapter of {net} {module} covers layers {sorted(found)}, "
                           f"the config has {n_layers}")
    for key in lora:
        module = key.rsplit(".lora_", 1)[0]
        if any(k not in lora for k in _adapter_keys(module)):
            raise KeyError(f"adapter of {module} lacks a factor")
    return lora


def lora_to_peft_state_dict(lora: Params) -> Dict[str, np.ndarray]:
    """The inverse of :func:`peft_state_dict_to_lora`: peft's prefixed keys,
    f32 numpy values (for publishing adapters)."""
    return {_PEFT_PREFIX + k: v.detach().float().cpu().numpy() for k, v in lora.items()}
