"""Mamba-2 (SSD) state-space kernels: the chunked prefill scan and the
one-event state update, with their plain PyTorch versions.

A Mamba-2 mixer (IBM Granite 4.0-H, HF ``GraniteMoeHybridMambaLayer.
torch_forward``) projects each row to a gate z [I], the convolution's input
xBC [I + 2 G N] and a time step dt [H]; xBC goes through a causal depthwise
convolution of width K (with bias) and SiLU and splits into x [H, P] and
B, C [G, N] (head h reads group h // (H / G)); then per head

    dt_t = softplus(dt_t + dt_bias),  A = -exp(A_log)
    h_t  = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t     (state [P, N], f32)
    y_t  = C_t . h_t + D x_t

and the gated RMSNorm ``w * rms(y * silu(z))`` feeds ``out_proj``.

- :func:`ssm_scan` runs whole prompts of one admission bucket (the SSD
  chunked form: chunks of ``chunk`` rows, the products within a chunk on
  tensor cores, the state handed from chunk to chunk).  Each prompt has its
  own length: its rows past it count for nothing, so its final state is the
  one at its own last row.  ``csrc/ssm_scan.cu`` on CUDA tensors,
  :func:`ssm_scan_reference` on CPU tensors.
- :func:`ssm_step` advances every slot by one row: the convolution over the
  slot's conv state and the new row (then the state shifted), SiLU,
  softplus, the f32 state updated IN PLACE, y, and the gated norm.
  ``csrc/ssm_step.cu`` on CUDA tensors, :func:`ssm_step_reference` on CPU
  tensors.
- :func:`causal_conv` is the prefill's convolution (plain PyTorch on both
  devices); it also returns each prompt's last K - 1 pre-convolution rows,
  the conv state a slot continues from.

Rounding (the kernels', which the plain versions follow so that bf16
inputs give the same function): the convolution sums in f32 and its SiLU
output is rounded to the model dtype; within a scan chunk the scores
C_i . B_j are f32, and their decayed, dt-weighted values are rounded to the
model dtype before they multiply x, as are the dt-weighted x that build a
chunk's state and the state that the next chunk's rows read; the states
and y stay f32.  In f32 nothing is rounded.

The kernels are built for bf16 models only (the card serves bf16); an f32
model on the card raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """HF ``GraniteMoeHybridRMSNormGated``: ``y * silu(z)`` normalised over
    the last axis in f32, cast to the weight's dtype, times the weight."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps)
    return weight * g.to(weight.dtype)


def causal_conv(xbc: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefill's causal depthwise convolution: ``xbc [G, S, C]``
    (zeros before row 0), ``weight [C, 1, K]``, ``bias [C]`` -> (SiLU of the
    convolution in xbc's dtype [G, S, C], each prompt's conv state
    [G, K - 1, C]: its rows ``lengths - K + 1 .. lengths - 1`` of xbc, zeros
    before its row 0).  Sums in f32."""
    g, s, c = xbc.shape
    k = weight.shape[-1]
    w = weight.reshape(c, k).float()
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    acc = bias.float().expand(g, s, c)
    for j in range(k):
        acc = acc + padded[:, j:j + s].float() * w[:, j]
    out = F.silu(acc).to(xbc.dtype)
    # padded row r holds xbc row r - (K - 1): a prompt's last K - 1 rows sit
    # at padded rows lengths .. lengths + K - 2
    rows = lengths.long()[:, None] + torch.arange(k - 1, device=xbc.device)[None, :]
    state = torch.gather(padded, 1, rows[..., None].expand(g, k - 1, c))
    return out, state


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def ssm_scan_reference(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
                       a: torch.Tensor, d: torch.Tensor, lengths: torch.Tensor, *,
                       chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`ssm_scan`, in its chunked form."""
    g_n, s, h, p = x.shape
    groups, n = b.shape[2], b.shape[3]
    dtype = x.dtype
    valid = torch.arange(s, device=x.device)[None, :] < lengths.long()[:, None]  # [G, S]
    dt = torch.where(valid[..., None], dt.float(), 0.0)
    xf = torch.where(valid[..., None, None], x.float(), 0.0)
    rep = h // groups
    bf = torch.where(valid[..., None, None], b.float(), 0.0).repeat_interleave(rep, dim=2)
    cf = torch.where(valid[..., None, None], c.float(), 0.0).repeat_interleave(rep, dim=2)
    pad = -s % chunk
    nc = (s + pad) // chunk

    def chunks(t):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)).reshape(g_n, nc, chunk, *t.shape[2:])

    xc, bc, cc, dtc = chunks(xf), chunks(bf), chunks(cf), chunks(dt)  # [G, nc, Q, ...]
    cum = torch.cumsum(dtc * a.float(), dim=2)  # [G, nc, Q, H]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [G, nc, i, j, H]
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg.clamp(max=0.0)), 0.0)
    scores = torch.einsum("gcihn,gcjhn->gcijh", cc, bc)
    weights = _rounded(scores * decay * dtc[:, :, None, :, :], dtype)
    y = torch.einsum("gcijh,gcjhp->gcihp", weights, xc)
    to_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # [G, nc, Q, H]
    xw = _rounded(xc * to_end[..., None], dtype)
    contrib = torch.einsum("gcjhp,gcjhn->gchpn", xw, bc)
    state = torch.zeros((g_n, h, p, n), dtype=torch.float32, device=x.device)
    off = []
    for k in range(nc):
        off.append(torch.einsum("gihn,ghpn->gihp", cc[:, k], _rounded(state, dtype))
                   * torch.exp(cum[:, k])[..., None])
        state = state * torch.exp(cum[:, k, -1])[..., None, None] + contrib[:, k]
    y = y + torch.stack(off, dim=1)
    y = y.reshape(g_n, nc * chunk, h, p)[:, :s] + d.float()[:, None] * xf
    return torch.where(valid[..., None, None], y, 0.0).contiguous(), state


def ssm_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, d: torch.Tensor, lengths: torch.Tensor, *,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of a bucket of prompts from a zero state.

    x [G, S, H, P] and b, c [G, S, G', N] (the convolution's output, model
    dtype); dt [G, S, H] f32 after softplus; a = -exp(A_log) and d [H] f32;
    lengths [G] int32 (1 .. S).  Returns (y [G, S, H, P] f32 with the D
    skip, zero at rows past a prompt's length; each prompt's state after its
    last row [G, H, P, N] f32).  ``csrc/ssm_scan.cu`` on CUDA tensors (bf16,
    ``chunk`` 256 or less, a multiple of 16), :func:`ssm_scan_reference` on
    CPU tensors."""
    if _build.on_cpu(x, b, c, dt, a, d, lengths):
        return ssm_scan_reference(x, b, c, dt, a, d, lengths, chunk=chunk)
    g_n, s, h, p = x.shape
    groups, n = b.shape[2], b.shape[3]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ssm_scan: the kernel is built for bf16 (got {x.dtype})")
    if (p, n) != (64, 128) or chunk > 256 or chunk % 16 or h % groups:
        raise ValueError(f"ssm_scan: the kernel takes 64 x 128 heads and chunks of up to 256 "
                         f"rows (got P={p}, N={n}, chunk {chunk}, {h} heads in {groups} groups)")
    for t, name in ((x, "x"), (b, "b"), (c, "c")):
        if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
            raise ValueError(f"ssm_scan: {name}'s heads must be packed rows")
    if x.stride(0) != s * x.stride(1) or b.stride(1) != c.stride(1) or b.stride(0) != c.stride(0):
        raise ValueError("ssm_scan: x, b and c must be row views of one layout each")
    _build.check(dt, "dt", torch.float32, (g_n, s, h))
    _build.check(a, "a", torch.float32, (h,))
    _build.check(d, "d", torch.float32, (h,))
    _build.check(lengths, "lengths", torch.int32, (g_n,))
    y = torch.empty((g_n, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((g_n, h, p, n), dtype=torch.float32, device=x.device)
    _build.call("mm_ssm_scan_bf16", x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
                a.data_ptr(), d.data_ptr(), lengths.data_ptr(), y.data_ptr(), state.data_ptr(),
                g_n, s, h, groups, x.stride(1), b.stride(1), b.stride(0), x.stride(0), chunk,
                _build.stream_ptr(x.device))
    _build.LAUNCHES["ssm_scan"] += 1
    return y, state


def split_projection(zxbcdt: torch.Tensor, inner: int, conv_dim: int):
    """An in_proj output [..., 2I + 2GN + H] as (z, xBC, dt) views."""
    return (zxbcdt[..., :inner], zxbcdt[..., inner:inner + conv_dim],
            zxbcdt[..., inner + conv_dim:])


def ssm_step_reference(zxbcdt: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
                       conv_weight: torch.Tensor, conv_bias: torch.Tensor,
                       dt_bias: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor,
                       norm_weight: torch.Tensor, eps: float, *, groups: int) -> torch.Tensor:
    """The plain version of :func:`ssm_step` (states updated in place)."""
    bsz, h, p, n = ssm_state.shape
    k = conv_weight.shape[-1]
    inner, conv_dim = h * p, conv_state.shape[-1]
    dtype = zxbcdt.dtype
    z, xbc, dt = split_projection(zxbcdt, inner, conv_dim)
    window = torch.cat([conv_state, xbc[:, None].to(conv_state.dtype)], dim=1)  # [B, K, C]
    w = conv_weight.reshape(conv_dim, k).float()
    acc = conv_bias.float().expand(bsz, conv_dim)
    for j in range(k):
        acc = acc + window[:, j].float() * w[:, j]
    xbc_c = _rounded(F.silu(acc), dtype)
    x = xbc_c[:, :inner].reshape(bsz, h, p)
    rep = h // groups
    bm = xbc_c[:, inner:inner + groups * n].reshape(bsz, groups, n).repeat_interleave(rep, dim=1)
    cm = xbc_c[:, inner + groups * n:].reshape(bsz, groups, n).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.float() + dt_bias.float())  # [B, H]
    decay = torch.exp(dt * -torch.exp(a_log.float()))
    new = ssm_state * decay[..., None, None] + (dt[..., None] * x)[..., None] * bm[:, :, None, :]
    y = (new * cm[:, :, None, :]).sum(-1) + d.float()[:, None] * x  # [B, H, P]
    ssm_state.copy_(new)
    conv_state.copy_(window[:, 1:])
    return gated_rms_norm(y.reshape(bsz, inner), z, norm_weight, eps)


_STEP_SCRATCH: dict = {}


def _step_scratch(device: torch.device, slots: int) -> torch.Tensor:
    """The step kernel's per-slot arrival counters (int32 zeros, left at zero
    by every launch), one buffer per device grown as needed."""
    buf = _STEP_SCRATCH.get(device)
    if buf is None or buf.numel() < slots:
        buf = _STEP_SCRATCH[device] = torch.zeros(max(slots, 256), dtype=torch.int32,
                                                  device=device)
    return buf


def ssm_step(zxbcdt: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
             conv_weight: torch.Tensor, conv_bias: torch.Tensor, dt_bias: torch.Tensor,
             a_log: torch.Tensor, d: torch.Tensor, norm_weight: torch.Tensor, eps: float, *,
             groups: int) -> torch.Tensor:
    """One row for every slot of one Mamba-2 layer.

    zxbcdt [B, 2I + 2GN + H] (in_proj's output, model dtype); conv_state
    [B, K - 1, C] (model dtype) and ssm_state [B, H, P, N] f32, both updated
    IN PLACE; the layer's parameters in the model dtype.  Returns the gated
    norm's output [B, I] in the model dtype, ``out_proj``'s input.  Every
    slot advances (the caller ignores slots that are not live; admission
    overwrites their state).  ``csrc/ssm_step.cu`` on CUDA tensors (bf16, P
    64, N 128, K 4), :func:`ssm_step_reference` on CPU tensors."""
    params = (conv_weight, conv_bias, dt_bias, a_log, d, norm_weight)
    if _build.on_cpu(zxbcdt, conv_state, ssm_state, *params):
        return ssm_step_reference(zxbcdt, conv_state, ssm_state, *params, eps, groups=groups)
    bsz, h, p, n = ssm_state.shape
    k = conv_weight.shape[-1]
    conv_dim = conv_state.shape[-1]
    inner = h * p
    dtype = zxbcdt.dtype
    if dtype != torch.bfloat16:
        raise TypeError(f"ssm_step: the kernel is built for bf16 (got {dtype})")
    if (p, n, k) != (64, 128, 4) or conv_dim != inner + 2 * groups * n or h % groups:
        raise ValueError(f"ssm_step: the kernel takes 64 x 128 heads and a width-4 "
                         f"convolution (got P={p}, N={n}, K={k}, C={conv_dim})")
    _build.check(zxbcdt, "zxbcdt", dtype, (bsz, inner + conv_dim + h))
    _build.check(conv_state, "conv_state", dtype, (bsz, k - 1, conv_dim))
    _build.check(ssm_state, "ssm_state", torch.float32)
    _build.check(conv_weight, "conv_weight", dtype, (conv_dim, 1, k))
    for t, name, size in ((conv_bias, "conv_bias", conv_dim), (dt_bias, "dt_bias", h),
                          (a_log, "A_log", h), (d, "D", h), (norm_weight, "norm", inner)):
        _build.check(t, name, dtype, (size,))
    out = torch.empty((bsz, inner), dtype=dtype, device=zxbcdt.device)
    # the gated values before the norm, and each (slot, head)'s sum of squares
    gated = torch.empty((bsz, inner + h), dtype=torch.float32, device=zxbcdt.device)
    _build.call("mm_ssm_step_bf16", zxbcdt.data_ptr(), conv_state.data_ptr(),
                ssm_state.data_ptr(), conv_weight.data_ptr(), conv_bias.data_ptr(),
                dt_bias.data_ptr(), a_log.data_ptr(), d.data_ptr(), norm_weight.data_ptr(),
                out.data_ptr(), gated.data_ptr(), _step_scratch(zxbcdt.device, bsz).data_ptr(),
                bsz, h, groups, float(eps), _build.stream_ptr(zxbcdt.device))
    _build.LAUNCHES["ssm_step"] += 1
    return out
