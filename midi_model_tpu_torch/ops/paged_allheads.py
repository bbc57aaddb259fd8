"""All-heads paged KV pools and paged flash-decode attention with append.

Counterpart of ``midi_model_tpu/ops/paged_allheads.py``.  Layout, kept from
the JAX package so the tests compare like with like:

- pools ``k, v: [n_pages, page_size, Hkv*stride]`` — one page row holds
  every kv head, head ``g`` in lanes ``[g*stride, g*stride + D)``;
- int8 pools add one bf16 scale pool ``scales: [n_pages, page_size, 128]``
  holding the per-token-per-head scales: k in lanes ``[0:Hkv]``, v in
  ``[Hkv:2Hkv]`` (:func:`combine_scales`);
- the layer axis is folded into pages and each slot's pages are contiguous
  from a base page (``(li*B + slot) * pages_per_slot`` in decode), so the
  kernels need no page table.

:func:`paged_attention_stats` runs a CUDA kernel on CUDA tensors — the
per-slot cell kernel (``csrc/paged_decode.cu``, :func:`paged_decode_cell`)
while every slot is short and the host knows it, else the streaming split-K
kernel (``csrc/paged_decode_stream.cu``, :func:`paged_decode_stream`) — and
:func:`decode_reference` + :func:`kv_append` (the plain version) on CPU
tensors.  Unlike the JAX
version, the append updates the pools IN PLACE; the returned pools are the
same tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

LANE = 128
PAGES_PER_BLOCK = 4  # the streaming kernel's work item: up to 4 pages of one slot
# the longest slot, in rows, up to which the cell kernel runs (paged_kernel):
# the longest uniform length at which it beat the streaming kernel on bf16
# and int8 pools in chip_smoke.py's time_paged_cell_vs_stream on an H100 80GB
# HBM3 at 700 W (B=32, 16 heads x 64; the streaming kernel led from 256 rows)
CELL_MAX_ROWS = 192


def head_stride(head_dim: int, kv_heads: int = 1) -> int:
    """Smallest per-head stride with ``kv_heads * stride % 128 == 0`` (the
    JAX package's lane alignment, kept so the pool layouts are identical;
    the real model, 16 heads x 64 dims, packs with no padding)."""
    stride = head_dim
    while (kv_heads * stride) % LANE:
        stride += 1
    return stride


class PagedPools(NamedTuple):
    """Event-KV paged pools ``k, v: [n_pages, page_size, Hkv*stride]`` (the
    model dtype, or int8 with ``scales [n_pages, page_size, 128]`` bf16)."""

    k: torch.Tensor
    v: torch.Tensor
    scales: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


def alloc_pools(kv_heads: int, n_pages: int, page_size: int, head_dim: int,
                dtype: torch.dtype, device: torch.device,
                quantized: bool = False) -> PagedPools:
    """Zeroed pools on ``device``; ``quantized`` selects int8 storage and a
    bf16 scale pool."""
    shape = (n_pages, page_size, kv_heads * head_stride(head_dim, kv_heads))
    if quantized:
        if 2 * kv_heads > LANE:
            raise ValueError(f"k+v scales of {kv_heads} kv heads do not fit one "
                             f"{LANE}-lane row")
        return PagedPools(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            scales=torch.zeros((n_pages, page_size, LANE), dtype=torch.bfloat16,
                               device=device))
    return PagedPools(k=torch.zeros(shape, dtype=dtype, device=device),
                      v=torch.zeros(shape, dtype=dtype, device=device))


def pack_heads(x: torch.Tensor, kv_heads: int, head_dim: int) -> torch.Tensor:
    """[..., Hkv, D] -> [..., Hkv*stride] (flat packed row, zero padded)."""
    hs = head_stride(head_dim, kv_heads)
    if head_dim < hs:
        x = torch.nn.functional.pad(x, (0, hs - head_dim))
    return x.reshape(*x.shape[:-2], kv_heads * hs)


def quantize_packed(x: torch.Tensor, kv_heads: int, head_dim: int):
    """[..., Hkv, D] -> (packed int8 [..., Hkv*stride], scales [..., Hkv] bf16).

    Symmetric per-token-per-head absmax; the scale is rounded to bf16 (the
    value the pool stores) before dividing, so dequantizing a stored value
    gives back exactly what quantize-then-dequantize gives."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = (absmax / 127.0 + 1e-12).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()[..., None]), -127, 127)
    return pack_heads(q.to(torch.int8), kv_heads, head_dim), scale


def combine_scales(k_scale: torch.Tensor, v_scale: torch.Tensor,
                   kv_heads: int) -> torch.Tensor:
    """k/v scales [..., Hkv] -> one scale row [..., 128] bf16 (lanes
    [0:Hkv] k, [Hkv:2Hkv] v, the rest zero)."""
    pad = torch.zeros((*k_scale.shape[:-1], LANE - 2 * kv_heads),
                      dtype=torch.bfloat16, device=k_scale.device)
    return torch.cat([k_scale.to(torch.bfloat16), v_scale.to(torch.bfloat16), pad],
                     dim=-1)


def split_scales(scales: torch.Tensor, kv_heads: int):
    """Inverse of :func:`combine_scales`: [..., 128] -> (k [..., Hkv], v [..., Hkv])."""
    return scales[..., :kv_heads], scales[..., kv_heads:2 * kv_heads]


def kv_append(pools: PagedPools, new_k: torch.Tensor, new_v: torch.Tensor,
              pages: torch.Tensor, offsets: torch.Tensor,
              new_scales: Optional[torch.Tensor] = None) -> PagedPools:
    """Write each slot's packed row [B, Hkv*stride] at (page, offset), in
    place; int8 pools also take the combined scale rows ``new_scales [B, 128]``."""
    pages, offsets = pages.long(), offsets.long()
    pools.k[pages, offsets] = new_k.to(pools.k.dtype)
    pools.v[pages, offsets] = new_v.to(pools.v.dtype)
    if pools.quantized:
        pools.scales[pages, offsets] = new_scales.to(torch.bfloat16)
    return pools


def decode_reference(q: torch.Tensor, pools: PagedPools, lengths: torch.Tensor,
                     base_pages: torch.Tensor, *, page_size: int,
                     pages_per_slot: int, kv_heads: int, head_dim: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense masked attention over each slot's gathered pages, in f32
    (counterpart of ``_decode_xla``; int8 pools dequantize as there:
    ``float(int8) * float(bf16 scale)``, an exact product).  q [B, H, D]
    pre-scaled."""
    b, h, d = q.shape
    hs = head_stride(head_dim, kv_heads)
    cap = pages_per_slot * page_size
    page_ids = (base_pages.long()[:, None]
                + torch.arange(pages_per_slot, device=q.device)[None, :])
    k = pools.k[page_ids].float().reshape(b, cap, kv_heads, hs)[..., :d]
    v = pools.v[page_ids].float().reshape(b, cap, kv_heads, hs)[..., :d]
    if pools.quantized:
        ks, vs = split_scales(pools.scales[page_ids], kv_heads)
        k = k * ks.reshape(b, cap, kv_heads).float()[..., None]
        v = v * vs.reshape(b, cap, kv_heads).float()[..., None]
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


def paged_kernel(max_length: Optional[int]) -> str:
    """The CUDA kernel for a call whose longest slot holds ``max_length``
    cached rows (None when the host does not know it, as under the batcher's
    per-slot lengths): ``"cell"`` up to :data:`CELL_MAX_ROWS` rows, where one
    block per (slot, head) walks them sooner than the streaming kernel splits
    and merges them, else ``"stream"``."""
    return "cell" if max_length is not None and max_length <= CELL_MAX_ROWS else "stream"


def paged_attention_stats(q: torch.Tensor, pools: PagedPools,
                          lengths: torch.Tensor, base_pages: torch.Tensor,
                          write: Optional[tuple] = None, *, page_size: int,
                          pages_per_slot: int, kv_heads: int, head_dim: int,
                          max_length: Optional[int] = None):
    """All-heads paged flash decode.  q: [B, H, D] f32 PRE-SCALED; lengths /
    base_pages: int32 [B].  Returns (o [B, H, D] f32, m [B, H], l [B, H]);
    a slot of length 0 gives o = 0, m = -inf, l = 0.

    ``write = (new_k [B, W], new_v [B, W], new_scales [B, 128] or None,
    write_pages [B], write_offs [B])`` also appends each slot's fresh packed
    row (int8 rows with their combined scale row for int8 pools; not
    visible to this call — lengths stop before it) and appends ``pools`` to
    the return tuple.

    ``max_length``, the longest of ``lengths`` when the host knows it,
    picks the kernel (:func:`paged_kernel`): :func:`paged_decode_cell` or
    :func:`paged_decode_stream`.  Both compute the same function."""
    decode = paged_decode_cell if paged_kernel(max_length) == "cell" else paged_decode_stream
    return decode(q, pools, lengths, base_pages, write, page_size=page_size,
                  pages_per_slot=pages_per_slot, kv_heads=kv_heads, head_dim=head_dim)


def _plain(q, pools, lengths, base_pages, write, geometry):
    """The plain version of both kernels: :func:`decode_reference`, then
    :func:`kv_append` of ``write``."""
    o, m, l = decode_reference(q, pools, lengths, base_pages, **geometry)
    if write is None:
        return o, m, l
    new_k, new_v, new_s, wpages, woffs = write
    return o, m, l, kv_append(pools, new_k, new_v, wpages, woffs, new_s)


def _kernel_args(q, pools, lengths, base_pages, write, *, page_size, kv_heads, head_dim):
    """Check a kernel call's tensors; returns (dtype suffix, the C entry
    points' leading pointer arguments, o, m, l)."""
    b, h, d = q.shape
    n_pages, ps, w = pools.k.shape
    dtype = pools.k.dtype
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}.get(dtype)
    if suffix is None or (dtype == torch.int8) != pools.quantized:
        raise TypeError(f"pools: no kernel for {dtype} (scales: {pools.quantized})")
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
    if pools.quantized:
        _build.check(pools.scales, "pools.scales", torch.bfloat16, (n_pages, ps, LANE))
    _build.check(lengths, "lengths", torch.int32, (b,))
    _build.check(base_pages, "base_pages", torch.int32, (b,))
    o = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    wptrs = [None] * 5
    if write is not None:
        new_k, new_v, new_s, wpages, woffs = write
        _build.check(new_k, "new_k", dtype, (b, w))
        _build.check(new_v, "new_v", dtype, (b, w))
        if pools.quantized:
            _build.check(new_s, "new_scales", torch.bfloat16, (b, LANE))
        _build.check(wpages, "write_pages", torch.int32, (b,))
        _build.check(woffs, "write_offs", torch.int32, (b,))
        wptrs = [new_k.data_ptr(), new_v.data_ptr(),
                 new_s.data_ptr() if pools.quantized else None,
                 wpages.data_ptr(), woffs.data_ptr()]
    scales = pools.scales.data_ptr() if pools.quantized else None
    ptrs = [q.data_ptr(), pools.k.data_ptr(), pools.v.data_ptr(), scales,
            lengths.data_ptr(), base_pages.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), *wptrs]
    return suffix, ptrs, o, m, l


def _tensors(q, pools, lengths, base_pages, write):
    tensors = [q, pools.k, pools.v, lengths, base_pages]
    if pools.quantized:
        tensors.append(pools.scales)
    if write is not None:
        tensors += [t for t in write if t is not None]
    return tensors


def paged_decode_cell(q: torch.Tensor, pools: PagedPools, lengths: torch.Tensor,
                      base_pages: torch.Tensor, write: Optional[tuple] = None, *,
                      page_size: int, pages_per_slot: int, kv_heads: int, head_dim: int):
    """:func:`paged_attention_stats` through the cell kernel
    (``csrc/paged_decode.cu``: one block per (slot, head)) on CUDA tensors,
    the plain version on CPU tensors."""
    geometry = dict(page_size=page_size, pages_per_slot=pages_per_slot,
                    kv_heads=kv_heads, head_dim=head_dim)
    if _build.on_cpu(*_tensors(q, pools, lengths, base_pages, write)):
        return _plain(q, pools, lengths, base_pages, write, geometry)
    b, h, d = q.shape
    w = pools.k.shape[2]
    suffix, ptrs, o, m, l = _kernel_args(q, pools, lengths, base_pages, write,
                                         page_size=page_size, kv_heads=kv_heads,
                                         head_dim=head_dim)
    _build.call(f"mm_paged_decode_{suffix}", *ptrs, b, h, kv_heads, d, w, page_size,
                int(write is not None), _build.stream_ptr(q.device))
    _build.LAUNCHES["paged_decode_int8" if pools.quantized else "paged_decode"] += 1
    return (o, m, l) if write is None else (o, m, l, pools)


def paged_decode_stream(q: torch.Tensor, pools: PagedPools, lengths: torch.Tensor,
                        base_pages: torch.Tensor, write: Optional[tuple] = None, *,
                        page_size: int, pages_per_slot: int, kv_heads: int,
                        head_dim: int):
    """:func:`paged_attention_stats` through the streaming split-K kernel
    (``csrc/paged_decode_stream.cu``: one block per (item, head) over a flat
    (slot, block of up to PAGES_PER_BLOCK pages) work list, then one merge
    block per slot that also appends) on CUDA tensors, the plain version on
    CPU tensors."""
    geometry = dict(page_size=page_size, pages_per_slot=pages_per_slot,
                    kv_heads=kv_heads, head_dim=head_dim)
    if _build.on_cpu(*_tensors(q, pools, lengths, base_pages, write)):
        return _plain(q, pools, lengths, base_pages, write, geometry)
    b, h, d = q.shape
    w = pools.k.shape[2]
    suffix, ptrs, o, m, l = _kernel_args(q, pools, lengths, base_pages, write,
                                         page_size=page_size, kv_heads=kv_heads,
                                         head_dim=head_dim)
    elt = pools.k.element_size()  # the kernel reads each head slice in 16-byte loads
    if 256 % d or (w // kv_heads * elt) % 16 or d % (16 // elt):
        raise ValueError(f"streaming decode: head_dim {d} must divide 256, and the "
                         f"head slices must be whole 16-byte vectors")
    # room for every block of every slot; the kernel maps each item to its
    # slot from the lengths, and items past the live ones exit at once
    n_items = b * -(-pages_per_slot // PAGES_PER_BLOCK)
    part_o = torch.empty((n_items, h, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((n_items, 2, h), dtype=torch.float32, device=q.device)
    _build.call(f"mm_paged_decode_stream_{suffix}", *ptrs, part_o.data_ptr(),
                part_ml.data_ptr(), b, h, kv_heads, d, w, page_size, PAGES_PER_BLOCK,
                n_items, int(write is not None), _build.stream_ptr(q.device))
    _build.LAUNCHES["paged_decode_stream"] += 1
    return (o, m, l) if write is None else (o, m, l, pools)
