"""Top-p / top-k categorical sampling with caller-supplied Gumbel noise.

Counterpart of ``midi_model_tpu/sampling/topk_topp.py``.  The keep rule is
the reference sampler's: on a stable descending sort, keep entries whose
*exclusive* cumulative mass is <= ``top_p`` and whose rank is < ``top_k``.
The draw is a Gumbel-argmax over the kept entries (``ops.sampler``), so it
is a function of the noise the caller passes — the same noise gives the
same ids on the kernel and on its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sampler import sample_top_p_k as _sample_op

K_CAP = 128  # >= the largest top_k the UI offers


def per_row(x, b: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Scalar or [B] -> contiguous [B] tensor of ``dtype`` on ``device``.

    A Python scalar becomes a fill on the device: copying it from the host
    would make the host wait for the device at every token step."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device, dtype=dtype)
    elif np.ndim(x) == 0:
        return torch.full((b,), x, dtype=dtype, device=device)
    else:
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return x.expand(b).contiguous() if x.ndim == 0 else x.reshape(b).contiguous()


def gumbel_noise(batch: int, generator: torch.Generator,
                 k_cap: int = K_CAP) -> torch.Tensor:
    """Standard Gumbel noise [batch, k_cap] f32 on the generator's device,
    drawn as ``-log(E)`` with ``E ~ Exp(1)`` clamped away from 0, so no value
    is infinite."""
    e = torch.empty((batch, k_cap), device=generator.device)
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
