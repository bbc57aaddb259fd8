"""All-heads paged KV pools and paged flash-decode attention with append.

Counterpart of ``midi_model_tpu/ops/paged_allheads.py`` (bf16/f32 pools;
int8 pools are not ported yet).  Layout, kept from the JAX package so the
tests compare like with like:

- pools ``k, v: [n_pages, page_size, Hkv*stride]`` — one page row holds
  every kv head, head ``g`` in lanes ``[g*stride, g*stride + D)``;
- the layer axis is folded into pages and each slot's pages are contiguous
  from a base page (``(li*B + slot) * pages_per_slot`` in decode), so the
  kernel needs no page table.

:func:`paged_attention_stats` runs the CUDA kernel (``csrc/paged_decode.cu``)
on CUDA tensors and :func:`decode_reference` + :func:`kv_append` (the plain
version) on CPU tensors.  Unlike the JAX version, the append updates the
pools IN PLACE; the returned pools are the same tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

LANE = 128


def head_stride(head_dim: int, kv_heads: int = 1) -> int:
    """Smallest per-head stride with ``kv_heads * stride % 128 == 0`` (the
    JAX package's lane alignment, kept so the pool layouts are identical;
    the real model, 16 heads x 64 dims, packs with no padding)."""
    stride = head_dim
    while (kv_heads * stride) % LANE:
        stride += 1
    return stride


class PagedPools(NamedTuple):
    """Event-KV paged pools ``k, v: [n_pages, page_size, Hkv*stride]``."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


def alloc_pools(kv_heads: int, n_pages: int, page_size: int, head_dim: int,
                dtype: torch.dtype, device: torch.device,
                quantized: bool = False) -> PagedPools:
    """Zeroed pools on ``device``."""
    if quantized:
        raise NotImplementedError("int8 paged pools are not ported yet")
    shape = (n_pages, page_size, kv_heads * head_stride(head_dim, kv_heads))
    return PagedPools(k=torch.zeros(shape, dtype=dtype, device=device),
                      v=torch.zeros(shape, dtype=dtype, device=device))


def pack_heads(x: torch.Tensor, kv_heads: int, head_dim: int) -> torch.Tensor:
    """[..., Hkv, D] -> [..., Hkv*stride] (flat packed row, zero padded)."""
    hs = head_stride(head_dim, kv_heads)
    if head_dim < hs:
        x = torch.nn.functional.pad(x, (0, hs - head_dim))
    return x.reshape(*x.shape[:-2], kv_heads * hs)


def kv_append(pools: PagedPools, new_k: torch.Tensor, new_v: torch.Tensor,
              pages: torch.Tensor, offsets: torch.Tensor) -> PagedPools:
    """Write each slot's packed row [B, Hkv*stride] at (page, offset), in place."""
    pages, offsets = pages.long(), offsets.long()
    pools.k[pages, offsets] = new_k.to(pools.k.dtype)
    pools.v[pages, offsets] = new_v.to(pools.v.dtype)
    return pools


def decode_reference(q: torch.Tensor, pools: PagedPools, lengths: torch.Tensor,
                     base_pages: torch.Tensor, *, page_size: int,
                     pages_per_slot: int, kv_heads: int, head_dim: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense masked attention over each slot's gathered pages, in f32
    (counterpart of ``_decode_xla``).  q [B, H, D] pre-scaled."""
    b, h, d = q.shape
    hs = head_stride(head_dim, kv_heads)
    cap = pages_per_slot * page_size
    page_ids = (base_pages.long()[:, None]
                + torch.arange(pages_per_slot, device=q.device)[None, :])
    k = pools.k[page_ids].float().reshape(b, cap, kv_heads, hs)[..., :d]
    v = pools.v[page_ids].float().reshape(b, cap, kv_heads, hs)[..., :d]
    groups = h // kv_heads
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bhd,bthd->bht", q.float(), k)
    valid = (torch.arange(cap, device=q.device)[None, None, :]
             < lengths.long()[:, None, None])
    scores = torch.where(valid, scores, -torch.inf)
    m = scores.max(dim=-1).values
    exp = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = exp.sum(dim=-1)
    probs = exp / torch.clamp(l, min=1e-30)[..., None]
    out = torch.einsum("bht,bthd->bhd", probs, v)
    return out, m, l


def paged_attention_stats(q: torch.Tensor, pools: PagedPools,
                          lengths: torch.Tensor, base_pages: torch.Tensor,
                          write: Optional[tuple] = None, *, page_size: int,
                          pages_per_slot: int, kv_heads: int, head_dim: int):
    """All-heads paged flash decode.  q: [B, H, D] f32 PRE-SCALED; lengths /
    base_pages: int32 [B].  Returns (o [B, H, D] f32, m [B, H], l [B, H]).

    ``write = (new_k [B, W], new_v [B, W], write_pages [B], write_offs [B])``
    also appends each slot's fresh packed row (not visible to this call —
    lengths stop before it) and appends ``pools`` to the return tuple.
    """
    tensors = [q, pools.k, pools.v, lengths, base_pages]
    if write is not None:
        tensors += list(write)
    if _build.on_cpu(*tensors):
        o, m, l = decode_reference(q, pools, lengths, base_pages,
                                   page_size=page_size,
                                   pages_per_slot=pages_per_slot,
                                   kv_heads=kv_heads, head_dim=head_dim)
        if write is None:
            return o, m, l
        return o, m, l, kv_append(pools, *write)

    b, h, d = q.shape
    n_pages, ps, w = pools.k.shape
    dtype = pools.k.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pools: no kernel for {dtype}")
    if ps != page_size or w != kv_heads * head_stride(head_dim, kv_heads):
        raise ValueError(f"pools shape {tuple(pools.k.shape)} does not match "
                         f"page_size={page_size}, kv_heads={kv_heads}, "
                         f"head_dim={head_dim}")
    if d != head_dim or d > 128 or h % kv_heads:
        raise ValueError(f"q shape {tuple(q.shape)}: head_dim <= 128 and "
                         f"heads divisible by kv_heads={kv_heads} required")
    _build.check(q, "q", torch.float32, (b, h, d))
    _build.check(pools.k, "pools.k", dtype)
    _build.check(pools.v, "pools.v", dtype, pools.k.shape)
    _build.check(lengths, "lengths", torch.int32, (b,))
    _build.check(base_pages, "base_pages", torch.int32, (b,))
    o = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    ptrs = [0, 0, 0, 0]
    if write is not None:
        new_k, new_v, wpages, woffs = write
        _build.check(new_k, "new_k", dtype, (b, w))
        _build.check(new_v, "new_v", dtype, (b, w))
        _build.check(wpages, "write_pages", torch.int32, (b,))
        _build.check(woffs, "write_offs", torch.int32, (b,))
        ptrs = [x.data_ptr() for x in write]
    name = ("mm_paged_decode_f32" if dtype == torch.float32
            else "mm_paged_decode_bf16")
    _build.call(name, q.data_ptr(), pools.k.data_ptr(), pools.v.data_ptr(),
                lengths.data_ptr(), base_pages.data_ptr(), o.data_ptr(),
                m.data_ptr(), l.data_ptr(), *ptrs, b, h, kv_heads, d, w,
                page_size, int(write is not None),
                _build.stream_ptr(q.device))
    _build.LAUNCHES["paged_decode"] += 1
    if write is None:
        return o, m, l
    return o, m, l, pools
