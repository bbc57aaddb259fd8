"""Top-p / top-k categorical sampling with caller-supplied Gumbel noise.

Counterpart of ``midi_model_tpu/sampling/topk_topp.py``.  The keep rule is
the reference sampler's: on a stable descending sort, keep entries whose
*exclusive* cumulative mass is <= ``top_p`` and whose rank is < ``top_k``.
The draw is a Gumbel-argmax over the kept entries (``ops.sampler``), so it
is a function of the noise the caller passes — the same noise gives the
same ids on the kernel and on its plain version.
"""

from __future__ import annotations

import torch

from ..ops.sampler import per_row
from ..ops.sampler import sample_top_p_k as _sample_op

K_CAP = 128  # >= the largest top_k the UI offers


def gumbel_rows(batch: int, t_max: int, generator: torch.Generator,
                k_cap: int = K_CAP) -> torch.Tensor:
    """One event's standard Gumbel noise, ``[t_max * batch, k_cap]`` f32 on
    the generator's device, in the JAX token-row kernel's step-major layout:
    row ``j * batch + r`` is step ``j`` of batch row ``r``.  Drawn as
    ``-log(E)`` with ``E ~ Exp(1)`` clamped away from 0, so no value is
    infinite.  Both decode paths draw it once per event, so one seed gives
    them the same noise."""
    e = torch.empty((t_max * batch, k_cap), device=generator.device)
    e.exponential_(generator=generator)
    return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 tensors holding 32-bit values, split in
    16-bit halves so no product leaves int64."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer: a bijection that spreads every input
    bit over the output."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def slot_gumbel(seeds: torch.Tensor, positions: torch.Tensor, t_max: int,
                k_cap: int = K_CAP) -> torch.Tensor:
    """Per-slot Gumbel noise from a counter-based hash: ``seeds [B]`` (one
    32-bit seed per slot) and ``positions [E, B]`` (each slot's sequence
    position at event e) -> ``[E, t_max * B, k_cap]`` f32 in
    :func:`gumbel_rows`' step-major layout, on ``positions``' device.

    Entry (e, j*B + b, k) is a function of ``(seeds[b], positions[e, b], j,
    k)`` alone — not of the slot index, the batch's other requests or the
    chunk size — so a seeded request reproduces under any batch
    composition (the counterpart of the JAX batcher's
    ``fold_in(PRNGKey(seed), index + e)`` streams; not the same numbers).
    Integer hashing in int64 torch ops, the same on the CPU and the card;
    the uniform keeps 24 bits, so no value is infinite."""
    e_n, b = positions.shape
    device = positions.device
    key = _mix32(seeds.to(device=device, dtype=torch.int64) & _MASK32)  # [B]
    pos = positions.to(torch.int64)[:, None, :, None]  # [E, 1, B, 1]
    j = torch.arange(t_max, device=device, dtype=torch.int64)[None, :, None, None]
    k = torch.arange(k_cap, device=device, dtype=torch.int64)[None, None, None, :]
    counter = ((pos * t_max + j) * k_cap + k) & _MASK32  # [E, T, B, K]
    h = _mix32(_mix32(counter ^ key[None, None, :, None]) ^ (key[None, None, :, None] >> 7))
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return (-torch.log(-torch.log(u))).reshape(e_n, t_max * b, k_cap)


def sample_top_p_k(probs: torch.Tensor, top_p, top_k,
                   gumbel: torch.Tensor) -> torch.Tensor:
    """probs [B, V] (need not be normalized); top_p / top_k scalars or per-row
    [B]; gumbel [B, k_cap] with ``top_k <= k_cap``.  Returns ids [B] int32."""
    b = probs.shape[0]
    return _sample_op(probs.float().contiguous(),
                      per_row(top_p, b, torch.float32, probs.device),
                      per_row(top_k, b, torch.int32, probs.device),
                      gumbel.contiguous())


def sample_greedy(probs: torch.Tensor) -> torch.Tensor:
    """The first maximum of each row, int32."""
    return torch.argmax(probs, dim=-1).to(torch.int32)
