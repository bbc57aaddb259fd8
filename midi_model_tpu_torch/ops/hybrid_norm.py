"""The elementwise work between a hybrid event net's products, one kernel
each (``csrc/hybrid_norm.cu``): a residual add with the RMSNorm that
follows it, and the SwiGLU product.  In a 40-layer decode step they stand
for ~700 small PyTorch operations, each a launch of its own.

:func:`add_rms_norm` and :func:`swiglu` run the kernels on CUDA bf16
tensors and their plain versions (the PyTorch operations they replace) on
CPU tensors.  The kernels round to bf16 where the plain versions do; only
the order of the norm's f32 sum differs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def add_rms_norm_reference(x: torch.Tensor, y: Optional[torch.Tensor], weight: torch.Tensor,
                           eps: float, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`add_rms_norm`."""
    if y is not None:
        x = x + y * scale
    return x, _rms_norm(x, weight, eps)


def add_rms_norm(x: torch.Tensor, y: Optional[torch.Tensor], weight: torch.Tensor, eps: float,
                 scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x' = x + y * scale, or x without y; RMSNorm(x') times ``weight``),
    rows of the last axis, in the dtype of ``x``: ``csrc/hybrid_norm.cu``
    on CUDA tensors (bf16, rows [B, D]), the plain version on CPU tensors."""
    tensors = (x, weight) if y is None else (x, y, weight)
    if _build.on_cpu(*tensors):
        return add_rms_norm_reference(x, y, weight, eps, scale)
    b, d = x.shape
    for t, name in zip(tensors, ("x", "y", "weight") if y is not None else ("x", "weight")):
        _build.check(t, name, torch.bfloat16, (d,) if name == "weight" else (b, d))
    x_out = torch.empty_like(x) if y is not None else x
    h = torch.empty_like(x)
    _build.call("mm_add_rms_norm_bf16", x.data_ptr(), None if y is None else y.data_ptr(),
                x_out.data_ptr(), h.data_ptr(), weight.data_ptr(), b, d, float(scale), float(eps),
                _build.stream_ptr(x.device))
    _build.LAUNCHES["add_rms_norm"] += 1
    return x_out, h


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` of the halves of ``gate_up [B, 2F]``:
    ``csrc/hybrid_norm.cu`` on CUDA tensors (bf16), the plain version on
    CPU tensors."""
    if _build.on_cpu(gate_up):
        gate, up = gate_up.chunk(2, dim=-1)
        return F.silu(gate) * up
    b, f2 = gate_up.shape
    _build.check(gate_up, "gate_up", torch.bfloat16, (b, f2))
    out = torch.empty((b, f2 // 2), dtype=gate_up.dtype, device=gate_up.device)
    _build.call("mm_swiglu_bf16", gate_up.data_ptr(), out.data_ptr(), b, f2 // 2,
                _build.stream_ptr(gate_up.device))
    _build.LAUNCHES["swiglu"] += 1
    return out
