"""Reference-layout state dicts and JAX parameter pytrees -> the port's model.

Counterpart of ``midi_model_tpu/interop/torch_ckpt.py``.  The reference's
checkpoints carry keys like ``net.layers.0.self_attn.q_proj.weight``
(torch ``[out, in]`` matrices), which are exactly the port's module names,
so a state dict loads straight into :class:`~..models.midinet.MIDINet`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.config import MIDIModelConfig
from ..models.midinet import MIDINet
from . import safetensors_io


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a ``.safetensors`` (the port's own reader, ``safetensors_io``) or
    torch-pickle (``.bin``/``.ckpt``) checkpoint into numpy arrays.  Pickles
    load with ``weights_only=True``."""
    path = str(path)
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.float().numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def params_from_state_dict(sd: Dict[str, np.ndarray], config: MIDIModelConfig,
                           dtype=torch.float32, device=None) -> MIDINet:
    """Reference-layout state dict -> a :class:`MIDINet` on ``device`` (None:
    the card).  Keys the model does not have are ignored; a missing key
    raises."""
    model = MIDINet(config, dtype=dtype, device=device)
    names = model.state_dict().keys()
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({n: torch.tensor(np.asarray(sd[n])) for n in names})
    return model


def state_dict_from_params(model: MIDINet) -> Dict[str, np.ndarray]:
    """The model's weights as a reference-layout state dict (numpy, f32)."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


_JAX_LAYER_NAMES = {
    "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
    "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
}


def from_jax_params(params_np: dict, config: MIDIModelConfig,
                    dtype=torch.float32, device=None) -> MIDINet:
    """The JAX package's parameter pytree (numpy leaves; ``[in, out]``
    matrices stacked on a leading layer axis) -> a :class:`MIDINet` on
    ``device`` (None: the card)."""
    sd: Dict[str, np.ndarray] = {}
    for prefix, cfg in (("net", config.net), ("net_token", config.net_token)):
        p = params_np[prefix]
        lp = p["layers"]
        for i in range(cfg.num_layers):
            for ours, theirs in _JAX_LAYER_NAMES.items():
                sd[f"{prefix}.layers.{i}.{theirs}"] = np.asarray(lp[ours][i]).T
            sd[f"{prefix}.layers.{i}.input_layernorm.weight"] = np.asarray(lp["ln_attn"][i])
            sd[f"{prefix}.layers.{i}.post_attention_layernorm.weight"] = np.asarray(lp["ln_mlp"][i])
        sd[f"{prefix}.embed_tokens.weight"] = np.asarray(p["embed"])
        sd[f"{prefix}.norm.weight"] = np.asarray(p["final_norm"])
    sd["lm_head.weight"] = np.asarray(params_np["lm_head"]).T
    sd = {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in sd.items()}
    return params_from_state_dict(sd, config, dtype=dtype, device=device)


def to_jax_tree(named: Dict[str, torch.Tensor], config: MIDIModelConfig) -> dict:
    """The inverse of :func:`from_jax_params` for any tree of the model's
    shape — weights, gradients, optimizer moments: a dict keyed by the
    port's parameter names (reference layout, torch ``[out, in]``) -> the
    JAX package's nested layout (``[in, out]`` matrices stacked on a leading
    layer axis), as f32 numpy arrays."""
    def get(name):
        return named[name].detach().float().cpu().numpy()

    tree = {}
    for prefix, cfg in (("net", config.net), ("net_token", config.net_token)):
        layers = {ours: np.stack([get(f"{prefix}.layers.{i}.{theirs}").T
                                  for i in range(cfg.num_layers)])
                  for ours, theirs in _JAX_LAYER_NAMES.items()}
        for ours, theirs in (("ln_attn", "input_layernorm.weight"),
                             ("ln_mlp", "post_attention_layernorm.weight")):
            layers[ours] = np.stack([get(f"{prefix}.layers.{i}.{theirs}")
                                     for i in range(cfg.num_layers)])
        tree[prefix] = {"embed": get(f"{prefix}.embed_tokens.weight"), "layers": layers,
                        "final_norm": get(f"{prefix}.norm.weight")}
    tree["lm_head"] = get("lm_head.weight").T
    return tree


def synthesize_state_dict(layout, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministically synthesize a reference-layout state dict.

    ``layout`` is a sequence of ``(name, shape)`` pairs in a fixed order.  One
    seeded ``np.random.default_rng`` fills the entries in that order: norm
    weights get ``1 + 0.05*N(0,1)``, all other weights ``0.02*N(0,1)``, fp32
    (the same draws as the JAX package's ``synthesize_state_dict``, so both
    rebuild the reference-oracle golden's weights)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, shape in layout:
        x = rng.standard_normal(tuple(shape)).astype(np.float32)
        if "layernorm" in name or name.endswith("norm.weight"):
            sd[name] = 1.0 + 0.05 * x
        else:
            sd[name] = 0.02 * x
    return sd
