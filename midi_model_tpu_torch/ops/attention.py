"""Attention: the plain dense version and the causal attention kernel.

Counterpart of ``midi_model_tpu/ops/attention.py``.  :func:`causal_attention`
runs the CUDA kernel (``csrc/causal_attention.cu``) on CUDA tensors, at
every sequence length (one code path; the JAX package's 512-row threshold
for its flash kernels was a TPU tuning), and :func:`attention_reference`
under the causal bias on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_bias: torch.Tensor) -> torch.Tensor:
    """q: [B,S,H,Dh]; k,v: [B,T,Hkv,Dh]; mask_bias additive [.,1,S,T].

    Counterpart of ``xla_attention``: f32 scores scaled by ``Dh**-0.5``, f32
    softmax, probabilities cast to the input dtype before P.V, which
    accumulates in f32; the output is in the input dtype."""
    h, dh = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * dh ** -0.5
    probs = torch.softmax(scores + mask_bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


def causal_bias(s: int, device: torch.device) -> torch.Tensor:
    """[1, 1, S, S] additive causal mask (0 on and below the diagonal)."""
    pos = torch.arange(s, device=device)
    bias = torch.where(pos[None, :] <= pos[:, None], 0.0, -torch.inf)
    return bias[None, None]


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """Causal self-attention, q: [B,S,H,Dh], k/v: [B,S,Hkv,Dh] (any strides
    with a contiguous last dim); returns a contiguous [B,S,H,Dh]."""
    if _build.on_cpu(q, k, v):
        return attention_reference(q, k, v, causal_bias(q.shape[1], q.device))
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"causal_attention: no kernel for {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if (tuple(k.shape) != (b, s, hkv, dh) or v.shape != k.shape
            or h % hkv or dh not in (64, 256)):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: head_dim 64 or 256")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head_dim axis must be contiguous")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    name = ("mm_causal_attention_f32" if q.dtype == torch.float32
            else "mm_causal_attention_bf16")
    _build.call(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, h, hkv, dh, ctypes.cast(strides, ctypes.c_void_p),
                _build.stream_ptr(q.device))
    _build.LAUNCHES["causal_attention"] += 1
    return out
