"""Model configuration: dataclasses + preset names + HF-config.json interop.

The jax-free counterpart of ``midi_model_tpu/models/config.py`` (that
module's package imports jax on import).  Presets follow the reference's
name scheme ``tv{1,2}[o]-{medium,large}``; the trailing "o" selects the
optimise_midi tokenizer mode.  JSON round-trips use the reference's HF
``config.json`` layout (keys ``tokenizer`` / ``net_config`` /
``net_token_config``).

A net's ``model_type`` picks its config class: ``llama`` (or no key) a
:class:`TransformerConfig`, ``granitemoehybrid`` a :class:`HybridConfig`
(IBM Granite 4.0-H's decoder: Mamba-2 and attention layers by
``layer_types``); any other raises.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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

    @property
    def model_type(self) -> str:
        return "llama"

    @staticmethod
    def from_hf_dict(d: Dict[str, Any]) -> "TransformerConfig":
        model_type = d.get("model_type", "llama")
        if model_type == HybridConfig.MODEL_TYPE:
            return HybridConfig.from_hf_dict(d)
        if model_type != "llama":
            raise ValueError(f"net config: unknown model_type {model_type!r} (the port "
                             f"runs 'llama' and {HybridConfig.MODEL_TYPE!r})")
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


@dataclass(frozen=True)
class HybridConfig(TransformerConfig):
    """IBM Granite 4.0-H's decoder stack (HF ``GraniteMoeHybridConfig``,
    ``model_type`` ``granitemoehybrid``, dense: no routed experts).

    Layer ``i`` mixes with a Mamba-2 block or with attention as
    ``layer_types[i]`` says; every layer has the SwiGLU ``shared_mlp`` of
    ``shared_intermediate_size`` (kept as ``intermediate_size``; HF's own
    ``intermediate_size``, which nothing reads, is kept as
    ``hf_intermediate_size``).  μP multipliers scale the embedding, each
    residual branch and the attention scores (in place of
    ``head_dim**-0.5``); ``position_embedding_type`` ``nope`` is attention
    without positions.  ``logits_scaling`` and ``tie_word_embeddings``
    belong to granite's causal-LM head and are only carried through."""

    MODEL_TYPE = "granitemoehybrid"

    layer_types: Tuple[str, ...] = ()
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 1.0
    logits_scaling: float = 1.0
    position_embedding_type: str = "nope"
    hf_intermediate_size: Optional[int] = None
    tie_word_embeddings: bool = False

    @property
    def model_type(self) -> str:
        return self.MODEL_TYPE

    @property
    def mamba_intermediate(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def conv_dim(self) -> int:
        """Channels of the causal convolution: x, then B and C."""
        return self.mamba_intermediate + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "attention")

    @property
    def mamba_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "mamba")

    def to_hf_dict(self) -> Dict[str, Any]:
        """Serialize with HF ``GraniteMoeHybridConfig`` field names."""
        return {
            "attention_bias": False,
            "attention_multiplier": self.attention_multiplier,
            "embedding_multiplier": self.embedding_multiplier,
            "hidden_act": "silu",
            "hidden_size": self.hidden_size,
            "intermediate_size": self.hf_intermediate_size,
            "layer_types": list(self.layer_types),
            "logits_scaling": self.logits_scaling,
            "mamba_chunk_size": self.mamba_chunk_size,
            "mamba_conv_bias": self.mamba_conv_bias,
            "mamba_d_conv": self.mamba_d_conv,
            "mamba_d_head": self.mamba_d_head,
            "mamba_d_state": self.mamba_d_state,
            "mamba_expand": self.mamba_expand,
            "mamba_n_groups": self.mamba_n_groups,
            "mamba_n_heads": self.mamba_n_heads,
            "mamba_proj_bias": self.mamba_proj_bias,
            "max_position_embeddings": self.max_position_embeddings,
            "model_type": self.MODEL_TYPE,
            "normalization_function": "rmsnorm",
            "num_attention_heads": self.num_heads,
            "num_experts_per_tok": 0,
            "num_hidden_layers": self.num_layers,
            "num_key_value_heads": self.kv_heads,
            "num_local_experts": 0,
            "position_embedding_type": self.position_embedding_type,
            "residual_multiplier": self.residual_multiplier,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_scaling": None,
            "rope_theta": self.rope_theta,
            "shared_intermediate_size": self.intermediate_size,
            "tie_word_embeddings": self.tie_word_embeddings,
            "vocab_size": self.vocab_size,
        }

    @staticmethod
    def from_hf_dict(d: Dict[str, Any]) -> "HybridConfig":
        layers = d["num_hidden_layers"]
        types = tuple(d.get("layer_types") or ())
        if len(types) != layers or set(types) - {"mamba", "attention"}:
            raise ValueError(f"granitemoehybrid: layer_types must name 'mamba' or "
                             f"'attention' for each of the {layers} layers (got {types})")
        if d.get("num_local_experts", 0):
            raise ValueError("granitemoehybrid: routed experts (num_local_experts > 0) are "
                             "not supported; the dense models have none")
        if d.get("position_embedding_type") not in (None, "nope"):
            raise ValueError(f"granitemoehybrid: position_embedding_type "
                             f"{d['position_embedding_type']!r}: only 'nope' is supported")
        if d.get("attention_bias", False) or d.get("mamba_proj_bias", False):
            raise ValueError("granitemoehybrid: projection biases are not supported")
        hidden, expand = d["hidden_size"], d.get("mamba_expand", 2)
        n_heads = d.get("mamba_n_heads", 128)
        d_head = d.get("mamba_d_head", "auto")
        if d_head == "auto":
            d_head = expand * hidden // n_heads
        if d_head * n_heads != expand * hidden:
            raise ValueError(f"granitemoehybrid: mamba_d_head x mamba_n_heads = "
                             f"{d_head} x {n_heads} is not mamba_expand x hidden_size")
        return HybridConfig(
            vocab_size=d["vocab_size"],
            hidden_size=hidden,
            num_layers=layers,
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads"),
            intermediate_size=d["shared_intermediate_size"],
            max_position_embeddings=d.get("max_position_embeddings", 2048),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 10000.0),
            initializer_range=d.get("initializer_range", 0.02),
            layer_types=types,
            mamba_n_heads=n_heads,
            mamba_d_head=d_head,
            mamba_d_state=d.get("mamba_d_state", 256),
            mamba_n_groups=d.get("mamba_n_groups", 1),
            mamba_d_conv=d.get("mamba_d_conv", 4),
            mamba_expand=expand,
            mamba_chunk_size=d.get("mamba_chunk_size", 256),
            mamba_conv_bias=d.get("mamba_conv_bias", True),
            mamba_proj_bias=d.get("mamba_proj_bias", False),
            embedding_multiplier=d.get("embedding_multiplier", 1.0),
            residual_multiplier=d.get("residual_multiplier", 1.0),
            attention_multiplier=d.get("attention_multiplier", 1.0),
            logits_scaling=d.get("logits_scaling", 1.0),
            position_embedding_type=d.get("position_embedding_type") or "nope",
            hf_intermediate_size=d.get("intermediate_size"),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
        )


def require_llama(config: "MIDIModelConfig", what: str) -> None:
    """Raise where ``config``'s event net is a hybrid, which ``what`` does
    not take (a hybrid is served by the continuous batcher on one device)."""
    if isinstance(config.net, HybridConfig):
        raise ValueError(f"{what} does not take a hybrid event net "
                         f"({HybridConfig.MODEL_TYPE}): the batcher serves one on one device")


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
