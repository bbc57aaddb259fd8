"""SkyTNT's hierarchical MIDI event transformer in plain float32 PyTorch.

Upstream (``midi_model.py``): an event is a row of ``T`` token ids whose
embedding is the sum of the row's token embeddings through the event net's
table; the event net (HF Llama layers) contextualizes the events; the token
net (HF Llama layers) decodes the next row token by token from the event's
hidden state, teacher-forced on the row's earlier tokens; one ``lm_head``
projects the token net's states to the vocabulary.  HF Llama: RMSNorm
``w * x / sqrt(mean(x^2) + eps)``, rotary embeddings in the rotate-half
layout with ``inv_freq = theta ** (-2i / d)``, causal softmax attention
scaled by ``d ** -0.5``, SwiGLU ``down(silu(gate(x)) * up(x))``, no biases.

``precision="fp8"`` is the control: every linear layer's weight (per
output row) and input (per row) rounded to float8 e4m3 with a scale, the
step below the bfloat16 that the configurations state.  Under autograd the
rounding passes the gradient straight through.

Matrix products run in float32 with TF32 off (:func:`full_f32`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")
QUERY_BLOCK = 1024  # rows of queries per attention block (bounds the score tile)


@contextlib.contextmanager
def full_f32():
    """float32 products with TF32 off, restored afterwards."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per row of its last axis
    (the row's largest magnitude maps to 448), back in float32; the
    gradient passes straight through."""
    amax = x.detach().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    scale = amax / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


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
