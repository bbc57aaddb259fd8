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
