"""The yardstick's arithmetic: published peaks of one H100 and the
operations and bytes of the model's work, from shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 67 TFLOP/s
f32 outside the tensor cores, 3.35 TB/s of HBM.  A share is stated against
them with the card's power limit beside it.

Operations count a multiply-add as 2.  A layer's products are its seven
projections; causal attention over ``c`` keys costs ``4 * heads * head_dim
* c`` per query (QK^T and PV).  Embedding gathers and norms are not
counted: the counts are a floor on the work, so a share never overstates.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


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


def attention_fwd(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                  elem: int = 2) -> tuple:
    """(operations, bytes) of one causal attention forward: q, k, v read
    once and the output written once."""
    flops = 4.0 * batch * heads * head_dim * seq * (seq + 1) / 2
    n_bytes = elem * batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    return flops, n_bytes


def attention_bwd(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                  elem: int = 2) -> tuple:
    """(operations, bytes) of its backward: the scores recomputed and four
    products (dV, dP, dQ, dK), 2.5 times the forward's; q, k, v, out, dout
    and the row statistics read once, dq, dk, dv written once."""
    flops = 2.5 * 4.0 * batch * heads * head_dim * seq * (seq + 1) / 2
    n_bytes = (elem * batch * seq * head_dim * (4 * heads + 4 * kv_heads)
               + 4 * batch * heads * seq)
    return flops, n_bytes


def bound_s(flops: float, n_bytes: float, dtype: str = "bfloat16") -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def train_forward_flops(config: dict, batch) -> float:
    """The forward's model operations for a training batch ``[..., L, T]``
    (numpy), counting only non-pad work: the event net over each row's
    non-pad input events, the token row for each non-pad target event."""
    import numpy as np

    pad = config["tokenizer"]["pad_id"]
    rows = np.asarray(batch).reshape(-1, *np.asarray(batch).shape[-2:])
    ev, _ = dims(config)
    total = 0.0
    for r in rows:
        n_in = int((r[:-1, 0] != pad).sum())
        n_out = int((r[1:, 0] != pad).sum())
        total += prefill_flops(config, n_in) + n_out * token_row_flops(config)
    return total
