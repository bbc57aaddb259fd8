"""One event-net decode step over all layers in one launch.

Counterpart of ``midi_model_tpu/ops/fused_step.py``.  The CUDA kernel is
``csrc/fused_step.cu``; :func:`fused_decode_step_reference` is its plain
PyTorch version.  Per layer: RMSNorm, the fused q/k/v product, RoPE at each
slot's position, paged attention over the slot's cached rows with the fresh
row's own term merged in f32, the append of the fresh k/v row, o-proj and
the SwiGLU MLP.  Rounding points are the TPU kernel's (``fused_step.py:
147-152, 326-329, 370-378``): the query is pre-scaled in f32; the cache
scores use it rounded to the pool dtype (``qsb``), the self term the f32
one (``qs32``); the softmax weights are rounded to the pool dtype before
P.V while their sum ``l`` and the merge stay f32.

MHA only, with packed pages (``head_stride == head_dim``); bf16 or f32
pools of the weights' dtype, or int8 pools with their bf16 scale pool
(``fused_step.py:466-660``, the TPU kernel's quantized form).  Ragged
``index`` and an ``active`` mask are supported: an inactive slot attends
over nothing.  As in the TPU kernel, every slot's fresh row is written at
``clip(index, 0, cap-1)`` on bf16/f32 pools, but only the active slots' rows
on int8 pools.  The pools are updated IN PLACE (the returned pools are the
same tensors).

On int8 pools the kernel reads the pools and never writes them.  A cached
row dequantizes in the attention math: its score is ``(k_int8 . qsb) *
k_scale``, and its softmax weight times its v scale is rounded to bf16
before P.V, while ``l`` sums the weights without the v scale.  The kernel
returns each layer's fresh rows ``[L, B, W]``; :func:`_append_int8` then
quantizes them per token and head (``quantize_packed``) and scatters them
with their scale rows, as the JAX wrapper does outside its kernel.  The
self term uses the unquantized fresh row in f32, as on bf16 pools.

The kernel's attention phase splits each slot's rows into work items over
the whole grid; :func:`attention_plan` is its item rule, which the serving
batcher's counters and the CPU tests of the phase share.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.llama import LlamaStack, apply_rope, rms_norm, rope_cos_sin
from . import _build
from .paged_allheads import LANE, PagedPools, combine_scales, head_stride, quantize_packed


class FusedWeights(NamedTuple):
    """The event net's weights concatenated per layer (torch ``[out, in]``)."""

    wqkv: torch.Tensor  # [L, 3W, D]
    wo: torch.Tensor  # [L, D, W]
    wgu: torch.Tensor  # [L, 2F, D]
    wd: torch.Tensor  # [L, D, F]
    ln: torch.Tensor  # [L, 2, D]: attention norm, MLP norm
    final_norm: torch.Tensor  # [D]


def prepare_fused(stack: LlamaStack) -> FusedWeights:
    """Concatenate the per-layer projections once per model (one extra copy
    of the stack's weights; the callers hoist it out of the event loop)."""
    layers = stack.layers

    def stacked(fn):
        return torch.stack([fn(ly) for ly in layers]).contiguous()

    return FusedWeights(
        wqkv=stacked(lambda ly: torch.cat([ly.self_attn.q_proj.weight,
                                           ly.self_attn.k_proj.weight,
                                           ly.self_attn.v_proj.weight])),
        wo=stacked(lambda ly: ly.self_attn.o_proj.weight),
        wgu=stacked(lambda ly: torch.cat([ly.mlp.gate_proj.weight,
                                          ly.mlp.up_proj.weight])),
        wd=stacked(lambda ly: ly.mlp.down_proj.weight),
        ln=stacked(lambda ly: torch.stack([ly.input_layernorm.weight,
                                           ly.post_attention_layernorm.weight])),
        final_norm=stack.norm.weight)


# The attention phase's item plan (``csrc/fused_step.cuh`` ``attention_plan``)
ATTN_ITEMS = 128  # work items a layer, at most: no more than the smallest grid
ATTN_QUANTUM = 8  # a chunk is a multiple of this many rows
ATTN_CHUNK_MAX = 256  # rows of a chunk, at most


def attention_plan(lengths, alive=None):
    """The whole-step kernel's attention work items for one event, from the
    slots' cached lengths int [B] and the alive mask bool [B] (None: every
    slot lives); leading axes are events.  Returns (chunk, items [B]): a live
    slot of n rows has max(1, ceil(n / chunk)) items of at most ``chunk``
    rows, a retired slot none; ``chunk`` is the smallest multiple of
    ``ATTN_QUANTUM`` rows, at most ``ATTN_CHUNK_MAX``, that cuts the live
    rows into at most ``ATTN_ITEMS`` items (slots of no rows do not count)."""
    lengths = np.asarray(lengths, np.int64)
    live = np.ones(lengths.shape, bool) if alive is None else np.asarray(alive, bool)
    rows = np.where(live, lengths, 0)
    chunks = np.arange(ATTN_QUANTUM, ATTN_CHUNK_MAX + 1, ATTN_QUANTUM)
    fits = (-(-rows[..., None, :] // chunks[:, None])).sum(-1) <= ATTN_ITEMS
    chunk = np.where(fits.any(-1), chunks[fits.argmax(-1)], ATTN_CHUNK_MAX)
    items = np.where(live, np.maximum(1, -(-rows // chunk[..., None])), 0)
    return (int(chunk) if chunk.ndim == 0 else chunk), items


def chunk_attention_counts(index, active, n_events: int, capacity: int):
    """(work items, slots of more than one item) of the attention phase
    per layer, summed over a ragged event-loop launch of ``n_events``
    events from each slot's length ``index`` and ``active`` (host arrays),
    as if no slot drew eos: event e's lengths are ``index + e``, and a slot
    retires once ``index + e`` reaches the capacity."""
    index = np.asarray(index, np.int64)[None, :]
    e = np.arange(n_events)[:, None]
    alive = np.asarray(active, bool)[None, :] & ((e == 0) | (index + e < capacity))
    _, items = attention_plan(np.minimum(index + e, capacity), alive)
    return int(items.sum()), int((items > 1).sum())


def attention_work_floats(batch: int, heads: int, head_dim: int, capacity: int) -> int:
    """Floats of the attention phase's global scratch: an arrival counter a
    slot, then a record an item of 64-bit words (its heads' maxima and
    exp-sums, and its P.V sums)."""
    items = max(ATTN_ITEMS + batch, batch * -(-capacity // ATTN_CHUNK_MAX))
    return -(-batch // 32) * 32 + items * 2 * (heads * head_dim + 2 * heads)


def _packed_mha(cfg) -> bool:
    return (cfg.kv_heads == cfg.num_heads
            and head_stride(cfg.head_dim, cfg.num_heads) == cfg.head_dim)


def kernel_limits(cfg, batch: int, capacity: int) -> Optional[str]:
    """Why the whole-step kernel cannot take the event net ``cfg`` at
    ``batch`` slots of ``capacity`` rows, or None when it can."""
    if not _packed_mha(cfg):
        return "fused step: MHA event net with head_stride == head_dim required"
    dh, d, f = cfg.head_dim, cfg.hidden_size, cfg.intermediate_size
    w = cfg.num_heads * dh
    if (dh % 64 or dh > 128 or w not in (512, 1024, 2048) or batch > 256 or d % 8
            or f % 8 or capacity > 16384):
        return (f"fused step kernel: head_dim 64 or 128, heads x head_dim 512, 1024 "
                f"or 2048, at most 256 slots of at most 16384 rows, widths multiples of "
                f"8 (got {dh}, W={w}, {batch}, {capacity}, D={d}, F={f})")
    return None


def phase_kinds(n_layers: int) -> list:
    """The kind of each phase of a whole-step launch, in order."""
    return ["norm+qkv", "attention", "o-proj", "gate/up", "down"] * n_layers


def _slot_tables(index, active, b, capacity, device):
    index = index.to(device=device, dtype=torch.int32)
    if active is None:
        lengths = index.clamp(max=capacity)
    else:
        lengths = torch.where(active.to(device=device, dtype=torch.bool),
                              index.clamp(max=capacity), 0).to(torch.int32)
    return index, lengths.contiguous(), index.clamp(0, capacity - 1).contiguous()


def _check_shapes(fused: FusedWeights, cfg, pools: PagedPools, b: int,
                  page_size: int, pages_per_slot: int):
    if (pools.k.dtype == torch.int8) != pools.quantized:
        raise TypeError(f"pools: {pools.k.dtype} with scales: {pools.quantized}")
    if not _packed_mha(cfg):
        raise ValueError("fused step: MHA event net with head_stride == "
                         "head_dim required")
    n_layers = fused.wqkv.shape[0]
    w = cfg.num_heads * cfg.head_dim
    shape = (n_layers * b * pages_per_slot, page_size, w)
    if tuple(pools.k.shape) != shape or pools.v.shape != pools.k.shape:
        raise ValueError(f"pools {tuple(pools.k.shape)}, expected {shape}")


def fused_decode_step_reference(fused: FusedWeights, cfg, x: torch.Tensor,
                                pools: PagedPools, index: torch.Tensor,
                                active: Optional[torch.Tensor] = None, *,
                                page_size: int, pages_per_slot: int,
                                append_inactive: bool = True):
    """The plain version of :func:`fused_decode_step`: per layer, dense
    masked attention over each slot's gathered pages.  With
    ``append_inactive=False`` an inactive slot appends nothing (the ragged
    event loop's retired slots)."""
    b, _ = x.shape
    _check_shapes(fused, cfg, pools, b, page_size, pages_per_slot)
    n_layers = fused.wqkv.shape[0]
    h, dh = cfg.num_heads, cfg.head_dim
    w = h * dh
    f = fused.wgu.shape[1] // 2
    dtype = fused.wqkv.dtype
    eps = cfg.rms_norm_eps
    capacity = pages_per_slot * page_size
    index, lengths, wpos = _slot_tables(index, active, b, capacity, x.device)
    cos, sin = rope_cos_sin(index[:, None], dh, cfg.rope_theta)  # [B, 1, dh]
    scale = dh ** -0.5
    valid = (torch.arange(capacity, device=x.device)[None, None, :]
             < lengths.long()[:, None, None])  # [B, 1, cap]
    slot_k = pools.k.view(n_layers * b, capacity, h, dh)
    slot_v = pools.v.view(n_layers * b, capacity, h, dh)
    if pools.quantized:  # per (row, head) k and v scales: [L*B, cap, H]
        slot_s = pools.scales.view(n_layers * b, capacity, LANE).float()
        slot_ks, slot_vs = slot_s[..., :h], slot_s[..., h:2 * h]
    slots = torch.arange(b, device=x.device)
    write_pages = slots * pages_per_slot + wpos.long() // page_size
    write_offs = wpos.long() % page_size
    appends = slots
    if not append_inactive and active is not None:
        appends = slots[active.to(device=x.device, dtype=torch.bool)]
    fresh = []  # int8 pools: each layer's fresh (k, v) rows, appended at the end

    x = x.to(dtype)
    for li in range(n_layers):
        qkv = F.linear(rms_norm(x, fused.ln[li, 0], eps), fused.wqkv[li])
        q, k, v = (t.view(b, 1, h, dh) for t in qkv.split(w, dim=-1))
        qr = apply_rope(q, cos, sin)[:, 0]  # [B, H, dh]
        kr = apply_rope(k, cos, sin)[:, 0]
        v = v[:, 0]
        qs32 = qr.float() * scale
        qsb = qs32.to(dtype).float()
        layer = slice(li * b, (li + 1) * b)
        kc = slot_k[layer].float()  # [B, cap, H, dh]
        vc = slot_v[layer]
        scores = torch.einsum("bhd,bthd->bht", qsb, kc)
        if pools.quantized:  # exact int8 x bf16 products, then the row's k scale
            scores = scores * slot_ks[layer].transpose(1, 2)
        scores = torch.where(valid, scores, -torch.inf)
        m = scores.max(dim=-1).values  # [B, H]; -inf for an empty slot
        pexp = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
        l = pexp.sum(dim=-1)
        if pools.quantized:  # the v scale folds into the weight, rounded to bf16
            weights = (pexp * slot_vs[layer].transpose(1, 2)).to(torch.bfloat16)
        else:
            weights = pexp.to(vc.dtype)
        acc = torch.einsum("bht,bthd->bhd", weights.float(), vc.float())
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        s_self = torch.sum(qs32 * kr.float(), dim=-1)
        m2 = torch.maximum(m, s_self)
        w_cache = l * torch.exp(m - m2)
        w_self = torch.exp(s_self - m2)
        attn = ((w_cache[..., None] * o + w_self[..., None] * v.float())
                / (w_cache + w_self)[..., None])
        if pools.quantized:
            fresh.append((kr.reshape(b, w), v.reshape(b, w)))
        else:  # append after every read of this layer's pages
            pages = li * b * pages_per_slot + write_pages[appends]
            pools.k[pages, write_offs[appends]] = kr.reshape(b, w)[appends].to(pools.k.dtype)
            pools.v[pages, write_offs[appends]] = v.reshape(b, w)[appends].to(pools.v.dtype)
        x = x + F.linear(attn.reshape(b, w).to(dtype), fused.wo[li])
        gate, up = F.linear(rms_norm(x, fused.ln[li, 1], eps),
                            fused.wgu[li]).split(f, dim=-1)
        x = x + F.linear(F.silu(gate) * up, fused.wd[li])
    if pools.quantized:
        kn, vn = (torch.stack(t) for t in zip(*fresh))
        _append_int8(pools, kn, vn, wpos, active, cfg, page_size=page_size,
                     pages_per_slot=pages_per_slot)
    return rms_norm(x, fused.final_norm, eps), pools


def _append_int8(pools: PagedPools, kn: torch.Tensor, vn: torch.Tensor,
                 wpos: torch.Tensor, active: Optional[torch.Tensor], cfg, *,
                 page_size: int, pages_per_slot: int) -> None:
    """Quantize every layer's fresh rows kn / vn [L, B, W] per token and head
    and write them, with their combined scale rows, at each ACTIVE slot's
    (page, wpos % page_size) of its layer (``fused_step.py:642-660``: an
    inactive slot's update is dropped), in place.  An inactive slot's row is
    written back with what it held: selecting the active slots would read
    the mask on the host and stall the stream every event."""
    n_layers, b, w = kn.shape
    h, dh = cfg.num_heads, cfg.head_dim
    device = kn.device
    kq, k_scale = quantize_packed(kn.view(n_layers, b, h, dh), h, dh)
    vq, v_scale = quantize_packed(vn.view(n_layers, b, h, dh), h, dh)
    srow = combine_scales(k_scale, v_scale, h)  # [L, B, 128]
    wpos = wpos.long()
    pages = ((torch.arange(n_layers, device=device)[:, None] * b
              + torch.arange(b, device=device)) * pages_per_slot
             + wpos // page_size).flatten()  # [L*B], distinct: a slot's pages are its own
    offs = (wpos % page_size).repeat(n_layers)
    keep = (None if active is None else
            ~active.to(device=device, dtype=torch.bool).repeat(n_layers)[:, None])
    for pool, rows in ((pools.k, kq), (pools.v, vq), (pools.scales, srow)):
        rows = rows.reshape(n_layers * b, -1)
        if keep is not None:
            rows = torch.where(keep, pool[pages, offs], rows)
        pool[pages, offs] = rows


def fused_decode_step(fused: FusedWeights, cfg, x: torch.Tensor,
                      pools: PagedPools, index: torch.Tensor,
                      active: Optional[torch.Tensor] = None, *,
                      page_size: int, pages_per_slot: int,
                      clock: Optional[torch.Tensor] = None):
    """One decode step of the event net ``cfg`` over all its layers.

    fused: :func:`prepare_fused` of the stack; x [B, D]: the new rows'
    embeddings; pools: the stack's paged pools; index int [B]: each slot's
    length BEFORE this row; active [B] bool (optional).  Returns (hidden
    [B, D] after the final norm, pools updated in place).  CPU tensors run
    the plain version, CUDA tensors the kernel (one launch) or raise.
    ``clock`` (CUDA only): a ``token_loop.phase_clock`` buffer the kernel
    stamps its phases into (:func:`phase_kinds`)."""
    tensors = [x, pools.k, pools.v, index, fused.wqkv]
    tensors += [t for t in (pools.scales, active) if t is not None]
    if _build.on_cpu(*tensors):
        return fused_decode_step_reference(
            fused, cfg, x, pools, index, active, page_size=page_size,
            pages_per_slot=pages_per_slot)

    b = x.shape[0]
    capacity = pages_per_slot * page_size
    index, lengths, wpos = _slot_tables(index, active, b, capacity, x.device)
    # the geometry of one event: [1, B] tables, [1, B, dh] RoPE rows
    cos, sin = rope_cos_sin(index[None, :], cfg.head_dim, cfg.rope_theta)
    bar = torch.zeros(2, dtype=torch.int32, device=x.device)
    ptrs, ints, floats, xs, fresh, keep = kernel_args(
        fused, cfg, x, pools, lengths[None], wpos[None], cos.contiguous(),
        sin.contiguous(), page_size=page_size, pages_per_slot=pages_per_slot,
        bar=bar, clock=clock)
    name = "mm_fused_step_" + ("f32" if fused.wqkv.dtype == torch.float32 else "bf16")
    if pools.quantized:
        name += "_int8"
    shape = _build.call_packed(name, ptrs, ints, floats, x.device)
    _build.count_launch("fused_step_int8" if pools.quantized else "fused_step", shape)
    if pools.quantized:
        _append_int8(pools, *fresh, wpos, active, cfg, page_size=page_size,
                     pages_per_slot=pages_per_slot)
    del keep
    return rms_norm(xs, fused.final_norm, cfg.rms_norm_eps), pools


def kernel_args(fused: FusedWeights, cfg, x: torch.Tensor, pools: PagedPools,
                lengths: torch.Tensor, wpos: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, *, page_size: int, pages_per_slot: int,
                bar: torch.Tensor, clock: Optional[torch.Tensor] = None):
    """Check a whole-step launch's CUDA inputs and pack them as the kernel's
    host arrays (``csrc/fused_step.cuh`` ``fill_step_params``).  The
    geometry has one row per event: lengths / wpos int32 [E, B], cos / sin
    f32 [E, B, dh]; bar: a zeroed int32 pair; clock: the phase clock or
    None.  The attention phase's scratch (:func:`attention_work_floats`)
    is allocated here; the kernel clears what it reads before writing it.
    Returns (ptrs, ints, floats, xs, fresh, keep): xs [B, D] is the residual
    stream the kernel updates in place (starting from x); fresh is None, or
    for int8 pools the kernel's fresh-row outputs (k, v) [L, B, W]; the
    tensors in ``keep`` must outlive the launch."""
    b, d = x.shape
    _check_shapes(fused, cfg, pools, b, page_size, pages_per_slot)
    dtype = fused.wqkv.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused step: no kernel for {dtype}")
    if pools.k.dtype != dtype and not pools.quantized:
        raise TypeError(f"fused step: pools {pools.k.dtype}, weights {dtype}")
    problem = kernel_limits(cfg, b, pages_per_slot * page_size)
    if problem:
        raise ValueError(problem)
    n_layers = fused.wqkv.shape[0]
    h, dh = cfg.num_heads, cfg.head_dim
    w = h * dh
    f = fused.wgu.shape[1] // 2
    n_events = lengths.shape[0]
    _build.check(fused.wqkv, "wqkv", dtype, (n_layers, 3 * w, d))
    _build.check(fused.wo, "wo", dtype, (n_layers, d, w))
    _build.check(fused.wgu, "wgu", dtype, (n_layers, 2 * f, d))
    _build.check(fused.wd, "wd", dtype, (n_layers, d, f))
    _build.check(fused.ln, "ln", dtype, (n_layers, 2, d))
    _build.check(pools.k, "pools.k", pools.k.dtype)
    _build.check(pools.v, "pools.v", pools.k.dtype, pools.k.shape)
    if pools.quantized:
        _build.check(pools.scales, "pools.scales", torch.bfloat16,
                     (*pools.k.shape[:2], LANE))
    _build.check(lengths, "lengths", torch.int32, (n_events, b))
    _build.check(wpos, "wpos", torch.int32, (n_events, b))
    _build.check(cos, "cos", torch.float32, (n_events, b, dh))
    _build.check(sin, "sin", torch.float32, (n_events, b, dh))
    device = x.device

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    xs = x.to(dtype=dtype, copy=True).contiguous()  # the residual stream
    # int8 pools: every layer's fresh k and v rows come out
    fresh = (empty(n_layers, b, w), empty(n_layers, b, w)) if pools.quantized else None
    # scratch: qkv, attention output, (the fresh k rows,) gated MLP input
    scratch = [empty(b, 3 * w), empty(b, w), fresh[0] if fresh else None, empty(b, f)]
    work = torch.empty(attention_work_floats(b, h, dh, pages_per_slot * page_size),
                       dtype=torch.float32, device=device)
    tensors = [fused.wqkv, fused.wo, fused.wgu, fused.wd, fused.ln, cos, sin,
               lengths, wpos, pools.k, pools.v, xs, *scratch, bar,
               pools.scales, fresh[1] if fresh else None, clock, work]
    ints = [b, d, h, dh, f, n_layers, page_size, pages_per_slot]
    return ([None if t is None else t.data_ptr() for t in tensors], ints,
            [cfg.rms_norm_eps, dh ** -0.5], xs, fresh, tensors)
