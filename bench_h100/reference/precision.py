"""What every architecture's reference shares: float32 products with TF32
off, and the fp8 rounding of the control.

``fp8`` is the control's precision: a linear layer's weight (per output
row) and input (per row) rounded to float8 e4m3 with a scale, the step
below the bfloat16 that the configurations state.  Under autograd the
rounding passes the gradient straight through.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "fp8")


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
