"""Attention: the plain dense version and the causal attention kernels.

Counterpart of ``midi_model_tpu/ops/attention.py``.  :func:`causal_attention`
runs the CUDA forward kernel (``csrc/causal_attention.cu``) on CUDA tensors,
at every sequence length (one code path; the JAX package's 512-row
threshold for its flash kernels was a TPU tuning), and
:func:`attention_reference` under the causal bias on CPU tensors.  At
head_dim 64 both dtypes run on the tensor cores: bf16 with a TMA + ``wgmma``
forward and an ``mma.sync`` backward, f32 with ``mma.sync`` forward and
backward kernels that run each f32 product as three TF32 products (3xTF32:
close to f32's accuracy, which the parity checks rely on).  At 256 both
dtypes run as packed rows on the CUDA cores.

Where a gradient is needed it is a ``torch.autograd.Function``: the forward
also keeps each row's f32 log-sum-exp, and the backward is the CUDA kernel
``csrc/causal_attention_bwd.cu`` on CUDA tensors (JAX trains through the
splash kernel's fused dq/dkv backward) and
:func:`causal_attention_backward_reference` — the same FlashAttention-2
formulas in plain PyTorch — on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_bias: torch.Tensor) -> torch.Tensor:
    """q: [B,S,H,Dh]; k,v: [B,T,Hkv,Dh]; mask_bias additive [.,1,S,T].

    Counterpart of ``xla_attention``: f32 scores scaled by ``Dh**-0.5``, f32
    softmax, probabilities cast to the input dtype before P.V, which
    accumulates in f32; the output is in the input dtype."""
    return _reference_with_lse(q, k, v, mask_bias)[0]


def _scores(q, k, h, scale=None):
    """f32 scores [B, H, S, T] scaled by ``scale`` (``Dh**-0.5`` by
    default), k repeated over each kv head's query heads."""
    dh = q.shape[3]
    k = k.float().repeat_interleave(h // k.shape[2], dim=2)
    return torch.einsum("bshd,bthd->bhst", q.float(), k) * (dh ** -0.5 if scale is None
                                                            else scale)


def _reference_with_lse(q, k, v, mask_bias, scale=None):
    """:func:`attention_reference` and each row's f32 log-sum-exp [B, H, S]."""
    h = q.shape[2]
    scores = _scores(q, k, h, scale) + mask_bias
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    v = v.float().repeat_interleave(h // v.shape[2], dim=2)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v)
    return out.to(q.dtype), lse


def causal_bias(s: int, device: torch.device) -> torch.Tensor:
    """[1, 1, S, S] additive causal mask (0 on and below the diagonal)."""
    pos = torch.arange(s, device=device)
    bias = torch.where(pos[None, :] <= pos[:, None], 0.0, -torch.inf)
    return bias[None, None]


def causal_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, out: torch.Tensor,
                                        dout: torch.Tensor, lse: torch.Tensor):
    """The plain version of the backward kernel: (dq, dk, dv) of causal
    attention from the forward's inputs, its output, the output's gradient
    and its f32 log-sum-exp ``lse [B, H, S]``, in FlashAttention-2 form:
    ``D = rowsum(dout * out)``, ``P = exp(s - lse)``, ``dv = P_T^T dout``
    with P rounded to the input dtype as the forward rounds it,
    ``dS = P * (dout v^T - D)``, ``dq = dS k * scale``,
    ``dk = dS^T q * scale``; a kv head's dk / dv sum over its query heads.
    f32 math; the gradients in the inputs' dtypes."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    groups = h // hkv
    scale = dh ** -0.5
    kr = k.float().repeat_interleave(groups, dim=2)
    vr = v.float().repeat_interleave(groups, dim=2)
    g = dout.float()
    causal = causal_bias(s, q.device) == 0
    p = torch.where(causal, torch.exp(_scores(q, k, h) - lse[..., None]), 0.0)
    delta = (g * out.float()).sum(dim=-1).transpose(1, 2)  # [B, H, S]
    dv = torch.einsum("bhst,bshd->bthd", p.to(q.dtype).float(), g)
    ds = p * (torch.einsum("bshd,bthd->bhst", g, vr) - delta[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, kr) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()) * scale
    dk = dk.view(b, s, hkv, groups, dh).sum(dim=3)
    dv = dv.view(b, s, hkv, groups, dh).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
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


def _kernel_strides(x: torch.Tensor):
    """x's (batch, position, head) strides in elements; a size-1 axis, whose
    stride is never applied, gets the stride it would have if it were
    contiguous over the axes inside it."""
    b, s, h, dh = x.shape
    sh = x.stride(2) if h > 1 else dh
    ss = x.stride(1) if s > 1 else sh * h
    sb = x.stride(0) if b > 1 else ss * s
    return sb, ss, sh


def _vector_ready(x: torch.Tensor) -> bool:
    """Whether the kernels can read x as it lies: they move 16 bytes at a
    time (TMA tensor maps at bf16 head_dim 64, ``cp.async`` at f32 head_dim
    64, 16-byte loads at 256), so the base is 16-byte aligned, every stride
    a multiple of 16 bytes (8 bf16 or 4 f32 elements), and the strides do
    not decrease from head to position to batch (the layout a tensor map
    describes: each axis steps over the whole of the axes inside it)."""
    sb, ss, sh = _kernel_strides(x)
    _, s, h, dh = x.shape
    n = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0 and sb % n == 0 and ss % n == 0 and sh % n == 0
            and sh >= dh and ss >= sh * h and sb >= ss * s)


def _vector_operand(x: torch.Tensor) -> torch.Tensor:
    """x, or a contiguous copy of it where :func:`_vector_ready` says the
    kernels cannot read it as it lies (the model's q, k and v, views of
    projections, are read in place)."""
    return x if _vector_ready(x) else x.clone(memory_format=torch.contiguous_format)


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*_kernel_strides(q), *_kernel_strides(k),
                                   *_kernel_strides(v))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool,
             scale=None):
    """(out, lse or None): the kernel on CUDA tensors, the plain version on
    CPU tensors; scores scaled by ``scale`` (``Dh**-0.5`` by default)."""
    if _build.on_cpu(q, k, v):
        out, lse = _reference_with_lse(q, k, v, causal_bias(q.shape[1], q.device), scale)
        return out, (lse if with_lse else None)
    _check(q, k, v)
    q, k, v = (_vector_operand(x) for x in (q, k, v))
    b, s, h, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = _strides(q, k, v)
    name = ("mm_causal_attention_f32" if q.dtype == torch.float32
            else "mm_causal_attention_bf16")
    _build.call(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, h, k.shape[2], dh,
                ctypes.cast(strides, ctypes.c_void_p), dh ** -0.5 if scale is None else scale,
                _build.stream_ptr(q.device))
    _build.LAUNCHES["causal_attention"] += 1
    return out, lse


def causal_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor):
    """(dq, dk, dv): the backward kernel on CUDA tensors (one wrapper call:
    the row sums, the dk/dv pass and the dq pass), the plain version on CPU
    tensors.  dq is [B, S, H, Dh], dk and dv [B, S, Hkv, Dh], contiguous."""
    if _build.on_cpu(q, k, v, out, dout, lse):
        return causal_attention_backward_reference(q, k, v, out, dout, lse)
    _check(q, k, v)
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    q, k, v, dout = (_vector_operand(x) for x in (q, k, v, dout.contiguous()))
    _build.check(out, "out", q.dtype, (b, s, h, dh))
    _build.check(dout, "dout", q.dtype, (b, s, h, dh))
    _build.check(lse, "lse", torch.float32, (b, h, s))
    dq = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, hkv, dh), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    name = ("mm_causal_attention_bwd_f32" if q.dtype == torch.float32
            else "mm_causal_attention_bwd_bf16")
    _build.call(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, dh,
                ctypes.cast(strides, ctypes.c_void_p), _build.stream_ptr(q.device))
    _build.LAUNCHES["causal_attention_bwd"] += 1
    return dq, dk, dv


@torch.library.custom_op("midi_model_tpu_torch::causal_attention_forward", mutates_args=())
def causal_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, f32 log-sum-exp): the forward kernel (or plain version) as an
    operator of the dispatcher, so that a selective-recompute policy
    (``models.llama``'s ``--remat dots_all``) can name it and save its
    outputs; the kernel's ctypes launch inside is invisible there."""
    out, lse = _forward(q, k, v, with_lse=True)
    return out, lse


@causal_attention_forward.register_fake
def _(q, k, v):
    b, s, h, dh = q.shape
    return q.new_empty((b, s, h, dh)), q.new_empty((b, h, s), dtype=torch.float32)


class _CausalAttention(torch.autograd.Function):
    """Causal attention with its backward kernel (or plain version)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = causal_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return causal_attention_backward(q, k, v, out, dout, lse)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale=None) -> torch.Tensor:
    """Causal self-attention, q: [B,S,H,Dh], k/v: [B,S,Hkv,Dh] (any strides
    with a contiguous last dim); returns a contiguous [B,S,H,Dh].  Scores
    are scaled by ``scale``, ``Dh**-0.5`` by default.  Where autograd
    records (a gradient enabled and an input that requires it) the forward
    keeps its log-sum-exp and the backward runs
    :func:`causal_attention_backward`, which takes the default scale only."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if scale is not None:
            raise ValueError("causal_attention: the backward takes the default scale only")
        return _CausalAttention.apply(q, k, v)
    return _forward(q, k, v, with_lse=False, scale=scale)[0]
