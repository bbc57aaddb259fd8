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
cell kernel (``csrc/paged_decode.cu``, :func:`paged_decode_cell`) while
every slot is short and the host knows it, else the streaming kernel
(``csrc/paged_decode_stream.cu``, :func:`paged_decode_stream`), one launch
per call either way — and :func:`decode_reference` + :func:`kv_append` (the
plain version) on CPU tensors.  Both kernels run one device routine
(``csrc/paged_decode.cuh``): a block computes one work item, a chunk of one
slot's rows, for all heads, and the slot's last block merges its chunks and
appends.  They differ in their work list: a (slot, chunk) grid sized from
the longest length, or a flat list over the live lengths found in the
kernel.  Unlike the JAX version, the append updates the pools IN PLACE; the
returned pools are the same tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

LANE = 128
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are built for
MAX_HEADS = 16  # query heads a slot: one warp each (csrc/paged_decode.cuh)
STREAM_ITEM_ROWS = 64  # the streaming kernel's work item: a chunk of up to 64 rows
CELL_BLOCKS_PER_SM = 2  # the cell grid's size: about this many items per SM
# the longest slot, in rows, up to which the cell kernel runs (paged_kernel):
# in chip_smoke.py's time_paged_cell_vs_stream (cold L2, B=32, 16 heads x 64)
# on an NVIDIA H100 80GB HBM3 at 700 W, the cell kernel beat the streaming
# one at every uniform length up to 256 rows on f32 and int8 pools and tied
# or beat it on bf16 (within 2% at 64 and 128 rows); from 1024 rows the
# streaming kernel led on all three
CELL_MAX_ROWS = 256


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
    per-slot lengths): ``"cell"`` up to :data:`CELL_MAX_ROWS` rows, where a
    grid sized from that length beats the streaming kernel's work-list scan,
    else ``"stream"``."""
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
    kw = dict(page_size=page_size, pages_per_slot=pages_per_slot, kv_heads=kv_heads,
              head_dim=head_dim)
    if paged_kernel(max_length) == "cell":
        return paged_decode_cell(q, pools, lengths, base_pages, write, max_length=max_length,
                                 **kw)
    return paged_decode_stream(q, pools, lengths, base_pages, write, **kw)


def _plain(q, pools, lengths, base_pages, write, geometry):
    """The plain version of both kernels: :func:`decode_reference`, then
    :func:`kv_append` of ``write``."""
    o, m, l = decode_reference(q, pools, lengths, base_pages, **geometry)
    if write is None:
        return o, m, l
    new_k, new_v, new_s, wpages, woffs = write
    return o, m, l, kv_append(pools, new_k, new_v, wpages, woffs, new_s)


def stage_rows(element_size: int) -> int:
    """Rows of k and v a kernel block stages per ring slot (``Tile`` in
    ``csrc/paged_decode.cuh``): ~32 KB at tv2o's 1,024-wide rows."""
    return 4 if element_size == 4 else 8


def chunks_of(length: int, rows: int) -> int:
    """Work items of up to ``rows`` rows in a slot of ``length`` rows (an
    empty slot is one item of no rows: it still writes its stats and
    appends)."""
    return max(1, -(-length // rows))


def cell_item_rows(batch: int, longest: int, rows_per_stage: int, sms: int) -> int:
    """The cell kernel's chunk: rows per work item so that ``batch`` slots of
    ``longest`` rows make about ``CELL_BLOCKS_PER_SM`` items per SM, a whole
    number of sub-tiles."""
    per_slot = max(1, -(-CELL_BLOCKS_PER_SM * sms // batch))
    rows = -(-max(longest, 1) // per_slot)
    return -(-rows // rows_per_stage) * rows_per_stage


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_ARRIVALS: dict = {}


def _arrivals(device: torch.device, batch: int) -> torch.Tensor:
    """The per-slot arrival counters of ``device``: int32 zeros, allocated
    once (grown for a larger batch) and left at zero by every launch.  One
    buffer per device, so calls must not overlap on two streams."""
    buf = _ARRIVALS.get(device)
    if buf is None or buf.numel() < batch:
        buf = _ARRIVALS[device] = torch.zeros(max(batch, 256), dtype=torch.int32,
                                              device=device)
    return buf


def _launch(entry: str, q, pools, lengths, base_pages, write, *, page_size, kv_heads,
            head_dim, item_rows: int, grid: int, items_per_slot: int, n_items: int):
    """Check a kernel call's tensors and launch ``entry`` (the dtype suffix
    added) on ``grid`` blocks; returns (o, m, l)."""
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
    if d != head_dim or d not in HEAD_DIMS or h > MAX_HEADS or h % kv_heads:
        raise ValueError(f"q shape {tuple(q.shape)}: head_dim one of {HEAD_DIMS}, at most "
                         f"{MAX_HEADS} heads, divisible by kv_heads={kv_heads}")
    _build.check(q, "q", torch.float32, (b, h, d))
    _build.check(pools.k, "pools.k", dtype)
    _build.check(pools.v, "pools.v", dtype, pools.k.shape)
    if pools.quantized:
        _build.check(pools.scales, "pools.scales", torch.bfloat16, (n_pages, ps, LANE))
    if any(t.data_ptr() % 16 for t in pools if t is not None):  # bulk copies: 16-byte aligned
        raise ValueError("pools must start on 16-byte boundaries")
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
    # scratch for the partials of slots with several items
    part = (torch.empty((n_items, h * (d + 2)), dtype=torch.float32, device=q.device)
            if items_per_slot > 1 else None)
    _build.call(f"{entry}_{suffix}", q.data_ptr(), pools.k.data_ptr(), pools.v.data_ptr(),
                pools.scales.data_ptr() if pools.quantized else None, lengths.data_ptr(),
                base_pages.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), *wptrs,
                None if part is None else part.data_ptr(),
                _arrivals(q.device, b).data_ptr(), b, h, kv_heads, d, w, page_size, item_rows,
                grid, int(write is not None), _build.stream_ptr(q.device))
    return o, m, l


def _tensors(q, pools, lengths, base_pages, write):
    tensors = [q, pools.k, pools.v, lengths, base_pages]
    if pools.quantized:
        tensors.append(pools.scales)
    if write is not None:
        tensors += [t for t in write if t is not None]
    return tensors


def paged_decode_cell(q: torch.Tensor, pools: PagedPools, lengths: torch.Tensor,
                      base_pages: torch.Tensor, write: Optional[tuple] = None, *,
                      page_size: int, pages_per_slot: int, kv_heads: int, head_dim: int,
                      max_length: Optional[int] = None):
    """:func:`paged_attention_stats` through the cell kernel
    (``csrc/paged_decode.cu``: a (slot, chunk) grid sized from
    ``max_length``, the longest of ``lengths``, or from the capacity when it
    is None) on CUDA tensors, the plain version on CPU tensors."""
    geometry = dict(page_size=page_size, pages_per_slot=pages_per_slot,
                    kv_heads=kv_heads, head_dim=head_dim)
    if _build.on_cpu(*_tensors(q, pools, lengths, base_pages, write)):
        return _plain(q, pools, lengths, base_pages, write, geometry)
    b = q.shape[0]
    capacity = pages_per_slot * page_size
    longest = capacity if max_length is None else min(max_length, capacity)
    rows = cell_item_rows(b, longest, stage_rows(pools.k.element_size()), _sms(q.device.index))
    chunks = chunks_of(longest, rows)
    o, m, l = _launch("mm_paged_decode", q, pools, lengths, base_pages, write,
                      page_size=page_size, kv_heads=kv_heads, head_dim=head_dim,
                      item_rows=rows, grid=chunks, items_per_slot=chunks,
                      n_items=b * chunks)
    _build.LAUNCHES["paged_decode_int8" if pools.quantized else "paged_decode"] += 1
    return (o, m, l) if write is None else (o, m, l, pools)


def paged_decode_stream(q: torch.Tensor, pools: PagedPools, lengths: torch.Tensor,
                        base_pages: torch.Tensor, write: Optional[tuple] = None, *,
                        page_size: int, pages_per_slot: int, kv_heads: int,
                        head_dim: int):
    """:func:`paged_attention_stats` through the streaming kernel
    (``csrc/paged_decode_stream.cu``: one block per item of a flat (slot,
    chunk of up to ``STREAM_ITEM_ROWS`` rows) list that the kernel finds from
    the lengths) on CUDA tensors, the plain version on CPU tensors."""
    geometry = dict(page_size=page_size, pages_per_slot=pages_per_slot,
                    kv_heads=kv_heads, head_dim=head_dim)
    if _build.on_cpu(*_tensors(q, pools, lengths, base_pages, write)):
        return _plain(q, pools, lengths, base_pages, write, geometry)
    # room for every chunk of every slot; blocks past the live list exit at once
    per_slot = chunks_of(pages_per_slot * page_size, STREAM_ITEM_ROWS)
    n_items = q.shape[0] * per_slot
    o, m, l = _launch("mm_paged_decode_stream", q, pools, lengths, base_pages, write,
                      page_size=page_size, kv_heads=kv_heads, head_dim=head_dim,
                      item_rows=STREAM_ITEM_ROWS, grid=n_items, items_per_slot=per_slot,
                      n_items=n_items)
    _build.LAUNCHES["paged_decode_stream"] += 1
    return (o, m, l) if write is None else (o, m, l, pools)
