"""Top-p / top-k categorical sampling by iterative max extraction.

Counterpart of ``midi_model_tpu/ops/sampler.py``.  The CUDA kernel is
``csrc/sampler.cu``; :func:`sample_top_p_k_reference` is its plain PyTorch
version.  Semantics (the reference sampler's, on a stable descending sort):

- extract the current maximum, ties broken by the lowest index;
- the j-th extracted element is kept iff its exclusive cumulative mass is
  <= ``top_p`` and ``j < top_k``;
- the draw is a Gumbel-argmax over the kept elements with the caller's
  noise ``gumbel[:, j]`` (``log p + g``, first maximum wins), so the result
  is deterministic given the inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build


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


def sample_top_p_k_reference(probs: torch.Tensor, top_p: torch.Tensor,
                             top_k: torch.Tensor, gumbel: torch.Tensor
                             ) -> torch.Tensor:
    """probs [B, V] f32; top_p [B] f32; top_k [B] i32; gumbel [B, k_cap] f32.
    Returns ids [B] int32."""
    b, _ = probs.shape
    k_cap = gumbel.shape[1]
    work = probs.float().clone()
    rows = torch.arange(b, device=probs.device)
    best = torch.full((b,), -torch.inf, device=probs.device)
    bidx = torch.zeros((b,), dtype=torch.int32, device=probs.device)
    texcl = torch.zeros((b,), device=probs.device)
    n_iter = min(int(top_k.max()), k_cap) if b else 0
    for j in range(n_iter):
        active = texcl <= top_p
        if not bool(active.any()):  # nothing later can be kept
            break
        idx = torch.argmax(work, dim=1)  # first maximum: lowest index
        m = work[rows, idx]
        keep = active & (j < top_k)
        score = torch.where(keep, torch.log(m) + gumbel[:, j], -torch.inf)
        upd = score > best
        best = torch.where(upd, score, best)
        bidx = torch.where(upd, idx.to(torch.int32), bidx)
        work[rows, idx] = 0.0
        texcl = texcl + m
    return bidx


def sample_top_p_k(probs: torch.Tensor, top_p: torch.Tensor,
                   top_k: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (no fallback).  Shapes as in the reference."""
    if _build.on_cpu(probs, top_p, top_k, gumbel):
        return sample_top_p_k_reference(probs, top_p, top_k, gumbel)
    b, v = probs.shape
    k_cap = gumbel.shape[1]
    _build.check(probs, "probs", torch.float32, (b, v))
    _build.check(top_p, "top_p", torch.float32, (b,))
    _build.check(top_k, "top_k", torch.int32, (b,))
    _build.check(gumbel, "gumbel", torch.float32, (b, k_cap))
    out = torch.empty((b,), dtype=torch.int32, device=probs.device)
    _build.call("mm_sampler", probs.data_ptr(), top_p.data_ptr(),
                top_k.data_ptr(), gumbel.data_ptr(), out.data_ptr(), b, v,
                k_cap, _build.stream_ptr(probs.device))
    _build.LAUNCHES["sampler"] += 1
    return out
