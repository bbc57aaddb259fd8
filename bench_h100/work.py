"""The yardstick's arithmetic: published peaks of one H100, the bound of a
piece of work, the causal attention kernels' operations and bytes, and the
model's work counts, which each configuration's architecture module gives
(``spec.architecture``) and the functions below hand on.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 67 TFLOP/s
f32 outside the tensor cores, 3.35 TB/s of HBM.  A share is stated against
them with the card's power limit beside it.
"""

from __future__ import annotations

from . import spec

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def dims(config: dict):
    """(event net, token net) shapes: ``layers``, ``heads``, ``kv_heads``,
    ``head_dim`` and more (the Llama family's ``Dims``)."""
    return spec.architecture(config).dims(config)


def token_row_flops(config: dict) -> float:
    """One event's token row."""
    return spec.architecture(config).token_row_flops(config)


def event_step_flops(config: dict, context: int) -> float:
    """One slot's event step over ``context`` cached rows, its token row
    included."""
    return spec.architecture(config).event_step_flops(config, context)


def prefill_flops(config: dict, rows: int) -> float:
    """The event net over a prompt of ``rows`` events."""
    return spec.architecture(config).prefill_flops(config, rows)


def weight_bytes(config: dict, elem: int = 2) -> float:
    """The weights an event step reads once."""
    return spec.architecture(config).weight_bytes(config, elem)


def cache_bytes(config: dict, context: int, pool: str) -> int:
    """The bytes of one slot's cache that one event step reads and appends,
    on pools of element ``pool`` (``bfloat16``, ``int8``, ...)."""
    return spec.architecture(config).cache_bytes(config, context, pool)


def train_forward_flops(config: dict, batch) -> float:
    """The forward's model operations for a training batch ``[..., L, T]``
    (numpy), non-pad work only."""
    return spec.architecture(config).train_forward_flops(config, batch)


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
