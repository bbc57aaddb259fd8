"""Model configuration: dataclasses + preset names + HF-config.json interop.

The jax-free counterpart of ``midi_model_tpu/models/config.py`` (that
module's package imports jax on import).  Presets follow the reference's
name scheme ``tv{1,2}[o]-{medium,large}``; the trailing "o" selects the
optimise_midi tokenizer mode.  JSON round-trips use the reference's HF
``config.json`` layout (keys ``tokenizer`` / ``net_config`` /
``net_token_config``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..tokenizer import MIDITokenizer

CONFIG_NAMES = ["tv1-medium", "tv2-medium", "tv2o-medium", "tv2-large", "tv2o-large"]


@dataclass(frozen=True)
class TransformerConfig:
    """One Llama-style decoder stack (HF-Llama semantics)."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    num_kv_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    # per-head width when it is NOT hidden/heads — the tensor-parallel
    # shard view divides heads but keeps the global hidden width
    # (sampling/sharded.py tp_local_config)
    head_dim_override: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads if self.num_kv_heads is not None else self.num_heads

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_heads

    def to_hf_dict(self) -> Dict[str, Any]:
        """Serialize with HF-LlamaConfig field names."""
        return {
            "model_type": "llama",
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "num_hidden_layers": self.num_layers,
            "num_attention_heads": self.num_heads,
            "num_key_value_heads": self.kv_heads,
            "intermediate_size": self.intermediate_size,
            "max_position_embeddings": self.max_position_embeddings,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_theta": self.rope_theta,
            "hidden_act": "silu",
            "tie_word_embeddings": False,
            "use_cache": False,
        }

    @staticmethod
    def from_hf_dict(d: Dict[str, Any]) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d.get("hidden_size", 4096),
            num_layers=d.get("num_hidden_layers", 32),
            num_heads=d.get("num_attention_heads", 32),
            num_kv_heads=d.get("num_key_value_heads"),
            intermediate_size=d.get("intermediate_size", 11008),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 10000.0),
        )


@dataclass(eq=False)
class MIDIModelConfig:
    """Hierarchical model config: tokenizer + event-level net + token-level net."""

    tokenizer: Any
    net: TransformerConfig
    net_token: TransformerConfig

    @property
    def n_embd(self) -> int:
        return self.net_token.hidden_size

    @staticmethod
    def get_config(tokenizer_ver: str = "v2", optimise_midi: bool = True,
                   n_layer: int = 12, n_head: int = 16, n_embd: int = 1024,
                   n_inner: int = 4096) -> "MIDIModelConfig":
        """The token net is a quarter-scale copy (layers/4, heads/4, ffn/4)
        of the event net, at the same hidden width."""
        tokenizer = MIDITokenizer(tokenizer_ver)
        tokenizer.set_optimise_midi(optimise_midi)
        net = TransformerConfig(
            vocab_size=tokenizer.vocab_size, hidden_size=n_embd,
            num_layers=n_layer, num_heads=n_head, intermediate_size=n_inner)
        net_token = TransformerConfig(
            vocab_size=tokenizer.vocab_size, hidden_size=n_embd,
            num_layers=n_layer // 4, num_heads=n_head // 4,
            intermediate_size=n_inner // 4)
        return MIDIModelConfig(tokenizer, net, net_token)

    @staticmethod
    def from_name(name: str = "tv2o-medium") -> "MIDIModelConfig":
        tv, size = name.split("-")
        tv = tv[1:]
        optimise = tv.endswith("o")
        if optimise:
            tv = tv[:-1]
        if tv not in ("v1", "v2"):
            raise ValueError(f"Unknown tokenizer version {tv}")
        if size == "medium":
            return MIDIModelConfig.get_config(tv, optimise, 12, 16, 1024, 4096)
        if size == "large":
            return MIDIModelConfig.get_config(tv, optimise, 24, 16, 1024, 4096)
        raise ValueError(f"Unknown model size {size}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model_type": "midi_model",
            "tokenizer": self.tokenizer.to_dict(),
            "net_config": self.net.to_hf_dict(),
            "net_token_config": self.net_token.to_hf_dict(),
            "n_embd": self.n_embd,
        }

    def save_pretrained(self, save_dir: str):
        """Write ``config.json`` into ``save_dir`` (the reference layout)."""
        import os

        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            f.write(json.dumps(self.to_dict(), indent=2))

    @staticmethod
    def from_json_file(path) -> "MIDIModelConfig":
        with open(path) as f:
            return MIDIModelConfig.from_dict(json.load(f))

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MIDIModelConfig":
        tok_d = d["tokenizer"]
        tokenizer = MIDITokenizer(tok_d["version"])
        tokenizer.set_optimise_midi(tok_d.get("optimise_midi", False))
        return MIDIModelConfig(
            tokenizer=tokenizer,
            net=TransformerConfig.from_hf_dict(d["net_config"]),
            net_token=TransformerConfig.from_hf_dict(d["net_token_config"]),
        )

    def __str__(self) -> str:
        return json.dumps(
            {"net": dataclasses.asdict(self.net),
             "net_token": dataclasses.asdict(self.net_token)}, indent=4)
