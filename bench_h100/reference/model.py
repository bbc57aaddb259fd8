"""The Llama family's architecture module: SkyTNT's hierarchical MIDI event
transformer in plain float32 PyTorch, its state-dict layout and the counts
of its work (what ``bench_h100/README.md`` asks of an architecture module).

Upstream (``midi_model.py``): an event is a row of ``T`` token ids whose
embedding is the sum of the row's token embeddings through the event net's
table; the event net (HF Llama layers) contextualizes the events; the token
net (HF Llama layers) decodes the next row token by token from the event's
hidden state, teacher-forced on the row's earlier tokens; one ``lm_head``
projects the token net's states to the vocabulary.  HF Llama: RMSNorm
``w * x / sqrt(mean(x^2) + eps)``, rotary embeddings in the rotate-half
layout with ``inv_freq = theta ** (-2i / d)``, causal softmax attention
scaled by ``d ** -0.5``, SwiGLU ``down(silu(gate(x)) * up(x))``, no biases.

``precision="fp8"`` is the control (:mod:`.precision`).  The judge runs
the model under ``precision.full_f32``: float32 products with TF32 off.

Counts: operations count a multiply-add as 2.  A layer's products are its
seven projections; causal attention over ``c`` keys costs ``4 * heads *
head_dim * c`` per query (QK^T and PV).  Embedding gathers and norms are
not counted: the counts are a floor on the work, so a share never
overstates.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import PRECISIONS, fp8_round

QUERY_BLOCK = 1024  # rows of queries per attention block (bounds the score tile)


class Net:
    """One stack of HF Llama layers over given input embeddings."""

    def __init__(self, prefix: str, cfg: dict, w: Dict[str, torch.Tensor], precision: str):
        self.prefix, self.w, self.precision = prefix, w, precision
        self.layers = cfg["num_hidden_layers"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg.get("num_key_value_heads") or self.heads
        self.hidden = cfg["hidden_size"]
        self.head_dim = cfg.get("head_dim") or self.hidden // self.heads
        self.eps = cfg.get("rms_norm_eps", 1e-6)
        self.theta = cfg.get("rope_theta", 10000.0)

    def p(self, name: str) -> torch.Tensor:
        return self.w[f"{self.prefix}.{name}"]

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.p(name)
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return x @ w.t()

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.p(name) * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))

    def rope(self, positions: torch.Tensor):
        d = self.head_dim
        inv_freq = 1.0 / (self.theta ** (torch.arange(0, d, 2, device=positions.device,
                                                      dtype=torch.float32) / d))
        freqs = positions.float()[:, None] * inv_freq[None, :]
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos(), emb.sin()

    @staticmethod
    def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=-1)
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    def attention(self, q, k, v):
        """Causal attention; q [B, H, S, d], k/v [B, Hkv, S, d] -> [B, S, H*d]."""
        b, h, s, d = q.shape
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        outs = []
        for at in range(0, s, QUERY_BLOCK):
            qb = q[:, :, at:at + QUERY_BLOCK]
            rows = torch.arange(at, at + qb.shape[2], device=q.device)
            cols = torch.arange(s, device=q.device)
            scores = (qb @ k.transpose(-1, -2)) / math.sqrt(d)
            scores = scores.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
            outs.append(torch.softmax(scores, dim=-1) @ v)
        return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * d)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, D] input embeddings -> hidden states after the final norm."""
        b, s, _ = x.shape
        cos, sin = self.rope(torch.arange(s, device=x.device))
        for i in range(self.layers):
            pre = f"layers.{i}."
            h = self.norm(x, pre + "input_layernorm.weight")
            q = self.linear(h, pre + "self_attn.q_proj.weight").view(b, s, self.heads, -1)
            k = self.linear(h, pre + "self_attn.k_proj.weight").view(b, s, self.kv_heads, -1)
            v = self.linear(h, pre + "self_attn.v_proj.weight").view(b, s, self.kv_heads, -1)
            q = self.rotate(q.transpose(1, 2), cos, sin)
            k = self.rotate(k.transpose(1, 2), cos, sin)
            attn = self.attention(q, k, v.transpose(1, 2))
            x = x + self.linear(attn, pre + "self_attn.o_proj.weight")
            h = self.norm(x, pre + "post_attention_layernorm.weight")
            gate = self.linear(h, pre + "mlp.gate_proj.weight")
            up = self.linear(h, pre + "mlp.up_proj.weight")
            x = x + self.linear(F.silu(gate) * up, pre + "mlp.down_proj.weight")
        return self.norm(x, "norm.weight")


class MidiModel:
    """The whole model over float32 copies of an upstream-layout state dict
    (``net.*``, ``net_token.*``, ``lm_head.weight``)."""

    def __init__(self, config: dict, state: Dict[str, torch.Tensor], precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.config = config
        self.w = {n: t.float() for n, t in state.items()}
        self.precision = precision
        self.pad_id = config["tokenizer"]["pad_id"]
        self.net = Net("net", config["net_config"], self.w, precision)
        self.net_token = Net("net_token", config["net_token_config"], self.w, precision)

    def parameters(self) -> Dict[str, torch.Tensor]:
        return self.w

    def event_hidden(self, rows: torch.Tensor) -> torch.Tensor:
        """rows [B, L, T] token ids -> event hidden states [B, L, D]."""
        emb = self.w["net.embed_tokens.weight"][rows.long()].sum(dim=-2)
        return self.net(emb)

    def token_logits(self, hidden: torch.Tensor, tokens: Optional[torch.Tensor]) -> torch.Tensor:
        """hidden [N, D] and a row's first tokens [N, j] -> logits [N, j + 1, V]:
        position i predicts token i of the row."""
        parts = [hidden[:, None, :]]
        if tokens is not None and tokens.shape[1]:
            parts.append(self.w["net_token.embed_tokens.weight"][tokens.long()])
        h = self.net_token(torch.cat(parts, dim=1))
        w = self.w["lm_head.weight"]
        if self.precision == "fp8":
            h, w = fp8_round(h), fp8_round(w)
        return h @ w.t()

    def loss(self, batch: torch.Tensor) -> torch.Tensor:
        """Upstream ``training_step``: next-event prediction, the token net
        teacher-forced on row i+1 from the event hidden at i; cross-entropy
        over every non-pad target token, mean."""
        x, y = batch[:, :-1], batch[:, 1:]
        hidden = self.event_hidden(x)
        hidden = hidden.reshape(-1, hidden.shape[-1])
        y = y.reshape(-1, y.shape[-1]).long()
        logits = self.token_logits(hidden, y[:, :-1])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1),
                               ignore_index=self.pad_id)


# The state-dict layout: every tensor here takes ``weights.make``'s default
# rule (a matrix from the one N(0, init_std) draw, a vector 1).

def layout(config: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every tensor of the upstream state dict (``net.*``,
    ``net_token.*``, ``lm_head.weight``), in the order they are drawn."""
    out = []
    vocab = config["tokenizer"]["vocab_size"]
    for prefix, key in (("net", "net_config"), ("net_token", "net_token_config")):
        c = config[key]
        d, h = c["hidden_size"], c["num_attention_heads"]
        hkv = c.get("num_key_value_heads") or h
        dh = c.get("head_dim") or d // h
        f = c["intermediate_size"]
        out.append((f"{prefix}.embed_tokens.weight", (vocab, d)))
        for i in range(c["num_hidden_layers"]):
            pre = f"{prefix}.layers.{i}."
            out += [(pre + "self_attn.q_proj.weight", (h * dh, d)),
                    (pre + "self_attn.k_proj.weight", (hkv * dh, d)),
                    (pre + "self_attn.v_proj.weight", (hkv * dh, d)),
                    (pre + "self_attn.o_proj.weight", (d, h * dh)),
                    (pre + "mlp.gate_proj.weight", (f, d)),
                    (pre + "mlp.up_proj.weight", (f, d)),
                    (pre + "mlp.down_proj.weight", (d, f)),
                    (pre + "input_layernorm.weight", (d,)),
                    (pre + "post_attention_layernorm.weight", (d,))]
        out.append((f"{prefix}.norm.weight", (d,)))
    out.append(("lm_head.weight", (vocab, config["net_config"]["hidden_size"])))
    return out


# The work counts, from shapes alone.

class Dims:
    def __init__(self, c: dict, vocab: int):
        self.layers = c["num_hidden_layers"]
        self.hidden = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.kv_heads = c.get("num_key_value_heads") or self.heads
        self.head_dim = c.get("head_dim") or self.hidden // self.heads
        self.inter = c["intermediate_size"]
        self.vocab = vocab

    @property
    def layer_params(self) -> int:
        d, hd, kvd = self.hidden, self.heads * self.head_dim, self.kv_heads * self.head_dim
        return 2 * d * hd + 2 * d * kvd + 3 * d * self.inter

    @property
    def kv_row_elems(self) -> int:
        """K and V elements of one cached row over all layers."""
        return 2 * self.layers * self.kv_heads * self.head_dim

    def attn_flops(self, queries: float, keys: float) -> float:
        return 4.0 * self.heads * self.head_dim * queries * keys * self.layers


def dims(config: dict):
    """(event net, token net) :class:`Dims`: the shapes the attention
    readers bound."""
    v = config["tokenizer"]["vocab_size"]
    return Dims(config["net_config"], v), Dims(config["net_token_config"], v)


def token_row_flops(config: dict) -> float:
    """One event's token row: the token net over T positions (causal
    attention within the row) and the head at each position."""
    _, tok = dims(config)
    t = config["tokenizer"]["row"]
    return (2.0 * tok.layer_params * tok.layers * t + tok.attn_flops(1, t * (t + 1) / 2)
            + 2.0 * tok.hidden * tok.vocab * t)


def event_step_flops(config: dict, context: int) -> float:
    """One slot's event step: its token row, then the event net's step for
    the new row over ``context`` cached rows and itself."""
    ev, _ = dims(config)
    return (token_row_flops(config) + 2.0 * ev.layer_params * ev.layers
            + ev.attn_flops(1, context + 1))


def prefill_flops(config: dict, rows: int) -> float:
    """The event net over a prompt of ``rows`` events (causal)."""
    ev, _ = dims(config)
    return 2.0 * ev.layer_params * ev.layers * rows + ev.attn_flops(1, rows * (rows + 1) / 2)


def weight_bytes(config: dict, elem: int = 2) -> float:
    """The weights an event step reads once: both nets' layers, the head."""
    ev, tok = dims(config)
    return elem * (ev.layer_params * ev.layers + tok.layer_params * tok.layers
                   + tok.hidden * tok.vocab)


POOL_ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}
SCALE_BYTES = 2  # an int8 pool's scale per (row, head) for k and for v: bf16


def cache_bytes(config: dict, context: int, pool: str) -> int:
    """The bytes of one slot's cache that one event step reads and appends:
    the K/V of its ``context`` cached rows read, the new row's written and
    read back (two rows more), over the event net's layers, at the pool's
    element width; int8 pools add the scale lanes a row's heads use (a k
    and a v scale a head, bf16).  The architecture keeps no other state."""
    ev, _ = dims(config)
    per_row = POOL_ELEM_BYTES[pool] * ev.kv_row_elems
    if pool == "int8":
        per_row += SCALE_BYTES * 2 * ev.layers * ev.kv_heads
    return per_row * (context + 2)


def train_forward_flops(config: dict, batch) -> float:
    """The forward's model operations for a training batch ``[..., L, T]``
    (numpy), counting only non-pad work: the event net over each row's
    non-pad input events, the token row for each non-pad target event."""
    import numpy as np

    pad = config["tokenizer"]["pad_id"]
    rows = np.asarray(batch).reshape(-1, *np.asarray(batch).shape[-2:])
    total = 0.0
    for r in rows:
        n_in = int((r[:-1, 0] != pad).sum())
        n_out = int((r[1:, 0] != pad).sum())
        total += prefill_flops(config, n_in) + n_out * token_row_flops(config)
    return total
