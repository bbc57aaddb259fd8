"""E whole events — token rows and event-net steps — in one launch.

Counterpart of ``midi_model_tpu/ops/event_loop.py`` in both its forms: the
aligned :func:`decode_event_block` (``merged_decode_events``: every slot at
the same history length) and the ragged :func:`decode_event_block_ragged`
(``merged_decode_ragged``: the continuous batcher's slots).  The CUDA
kernel is ``csrc/event_loop.cu``; ``decode_event_block_reference`` and
``decode_event_block_ragged_reference`` are its plain PyTorch versions.
For events ``e = 0..E-1``:

- the token row of ``ops.token_loop`` from the event net's hidden (the
  given one at ``e = 0``, the final norm of the previous event's residual
  after), with event ``e``'s noise plane ``gumbel[e]``;
- the event embedding of the sampled row: its 8 event-net embedding rows
  summed in f32 in step order and rounded once (:func:`event_embedding`, as
  the TPU kernel's one-hot f32 accumulation);
- the whole event-net step of ``ops.fused_step`` at the uniform length
  ``len0 + e``, appending at that position.

What one launch per E events removes, next to the token-row and whole-step
launches per event, is the host's work between them: the launches, the
embedding gather and the per-event geometry tables.

The ragged form gives each slot its own length and RoPE position
``index_s + e``, its own temp / top_p / top_k, allow row and noise, and an
``alive`` mask on the device (``merged_decode_ragged``'s semantics, the
batcher's split scan's too): it starts as ``active``; a retired slot
samples pad at every step, appends nothing and keeps its residual frozen (a
slot dead at entry ends with a zero residual, so its hidden is 0); after
event ``e`` a slot retires when its row's step 0 is eos or ``index_s + e +
1`` reaches the capacity — the eos row itself goes through the event net.
The caller derives the new index as ``index + sum_e(rows[e, :, 0] != pad)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import HybridConfig
from ..models.llama import rms_norm, rope_cos_sin
from . import _build
from . import fused_step as fs
from . import token_loop as tl

EVENTS_PER_LAUNCH = 8  # the JAX package's EVENTS_PER_DISPATCH


def why_not_fused(config, batch: int, capacity: int) -> Optional[str]:
    """Why the per-event kernel pair (token row, then the whole step) cannot
    take ``config`` at ``batch`` slots of ``capacity`` rows, or None when it
    can — on bf16, f32 and int8 pools alike (:func:`decode_path`'s
    ``fused=None``)."""
    if isinstance(config.net, HybridConfig):
        return (f"fused kernels: the event net is a {HybridConfig.MODEL_TYPE} hybrid "
                f"(Mamba-2 and attention layers): the split scan serves it")
    problem = (tl.kernel_limits(config, batch)
               or fs.kernel_limits(config.net, batch, capacity))
    if problem is None and config.net.hidden_size != config.net_token.hidden_size:
        problem = (f"fused kernels: the event and token nets' widths differ "
                   f"({config.net.hidden_size}, {config.net_token.hidden_size})")
    return problem


def decode_path(config, dtype: torch.dtype, batch: int, capacity: int, kv_int8: bool,
                fused: Optional[bool] = None, tp_group=None) -> str:
    """The decode path of ``ContinuousBatcher`` and ``decode_events``:
    "event_loop" (whole events a launch, pools of the weights' dtype, as the
    JAX package's event loop), "pair" (token row, then whole step, an event
    at a time: int8 pools) or "split" (token row, then the stack's
    ``decode_paged``).  ``fused`` None takes the fused kernels for bf16
    weights when :func:`why_not_fused` finds nothing in the way, int8 pools
    included (there the JAX package keeps them off after a v5e measurement;
    on the H100 the pair decoded faster than the split scan, ``chip_smoke.py``
    phase 5).  True under a model shard's ``tp_group`` or on a hybrid
    raises."""
    if tp_group is not None:
        if fused:
            raise ValueError("the fused kernels cannot all-reduce between layers: "
                             "a model axis takes the split scan")
        fused = False
    if fused and isinstance(config.net, HybridConfig):
        raise ValueError("the fused kernels do not take a hybrid event net: "
                         "the split scan serves it")
    if fused is None:
        fused = dtype == torch.bfloat16 and why_not_fused(config, batch, capacity) is None
    if not fused:
        return "split"
    return "pair" if kv_int8 else "event_loop"


def why_not_event_loop(config, batch: int, capacity: int,
                       pool_dtype: torch.dtype) -> Optional[str]:
    """Why the event-loop kernel (whole events per launch, aligned or
    ragged) cannot take ``config`` at ``batch`` slots of ``capacity`` rows
    with pools of ``pool_dtype``, or None when it can: the fused kernels'
    limits, and pools that :func:`decode_path` gives the per-event pair."""
    problem = why_not_fused(config, batch, capacity)
    if not problem and decode_path(config, pool_dtype, batch, capacity,
                                   kv_int8=pool_dtype == torch.int8, fused=True) == "pair":
        problem = "event loop: bf16/f32 pools only (int8 pools take the per-event pair)"
    return problem


def event_embedding(model, row: torch.Tensor) -> torch.Tensor:
    """row [B, T] ids -> [B, D]: the event net's embedding rows of the row's
    tokens summed in f32 in step order, rounded once to the model dtype."""
    table = model.net.embed_tokens.weight
    row = row.long()
    acc = table[row[:, 0]].float()
    for j in range(1, row.shape[1]):
        acc = acc + table[row[:, j]].float()
    return acc.to(model.dtype)


def decode_event_block_reference(model, config, fused: fs.FusedWeights,
                                 hidden: torch.Tensor, pools: fs.PagedPools,
                                 len0: int, masks, temp, top_p, top_k,
                                 gumbel: Optional[torch.Tensor], *,
                                 n_events: int, greedy: bool, page_size: int,
                                 pages_per_slot: int):
    """The plain version of :func:`decode_event_block`: per event, the plain
    token row, :func:`event_embedding` and the plain whole step."""
    b = hidden.shape[0]
    rows = []
    for e in range(n_events):
        row, _ = tl.decode_token_row_reference(
            model, config, hidden, masks, temp, top_p, top_k,
            None if greedy else gumbel[e], greedy=greedy)
        index = torch.full((b,), len0 + e, dtype=torch.int32, device=hidden.device)
        hidden, pools = fs.fused_decode_step_reference(
            fused, config.net, event_embedding(model, row), pools, index,
            page_size=page_size, pages_per_slot=pages_per_slot)
        rows.append(row)
    return torch.stack(rows), hidden, pools


def decode_event_block(model, config, fused: fs.FusedWeights,
                       hidden: torch.Tensor, pools: fs.PagedPools, len0: int,
                       masks, temp, top_p, top_k,
                       gumbel: Optional[torch.Tensor], *, n_events: int,
                       greedy: bool, page_size: int, pages_per_slot: int):
    """Decode ``n_events`` whole events, every slot at history length
    ``len0`` before the first (``len0 + n_events <= capacity``).

    model: a ``MIDINet``; fused: :func:`fused_step.prepare_fused` of its
    event net; hidden [B, D]: the event net's hidden (after the final norm)
    that conditions the first row; masks: (first, steps, pad_only) bool
    tensors; ``temp`` / ``top_p`` / ``top_k``: scalars or per-row [B];
    gumbel [n_events, T*B, k_cap] f32 (each event's ``gumbel_rows``; None
    when ``greedy``).  Returns (rows [n_events, B, T] int32, hidden after
    the last event's final norm, pools updated in place).  CPU tensors run
    the plain version, CUDA tensors the kernel (one launch) or raise."""
    args = (model, config, fused, hidden, pools, len0, masks, temp, top_p,
            top_k, gumbel)
    kw = dict(n_events=n_events, greedy=greedy, page_size=page_size,
              pages_per_slot=pages_per_slot)
    tensors = [hidden, *masks, pools.k, pools.v, fused.wqkv, model.lm_head.weight]
    tensors += [t for t in (temp, top_p, top_k, gumbel) if isinstance(t, torch.Tensor)]
    if _build.on_cpu(*tensors):
        return decode_event_block_reference(*args, **kw)

    b = hidden.shape[0]
    device = hidden.device
    capacity = pages_per_slot * page_size
    if n_events < 1 or len0 < 0 or len0 + n_events > capacity:
        raise ValueError(f"event loop: {n_events} events from length {len0} "
                         f"do not fit a capacity of {capacity}")
    problem = why_not_event_loop(config, b, capacity, pools.k.dtype)
    if problem:
        raise ValueError(problem)
    dtype = model.dtype
    if greedy:
        gumbel = None
    else:
        _build.check(gumbel, "gumbel", torch.float32,
                     (n_events, config.tokenizer.max_token_seq * b, gumbel.shape[-1]))
        gumbel = gumbel.view(-1, gumbel.shape[-1])
    # the geometry of every event: lengths = write positions = len0 + e
    lengths = (torch.arange(len0, len0 + n_events, dtype=torch.int32, device=device)
               [:, None].expand(n_events, b).contiguous())
    cos, sin = rope_cos_sin(lengths, config.net.head_dim, config.net.rope_theta)
    bar = torch.zeros(2, dtype=torch.int32, device=device)
    tptrs, tints, tfloats, rows, _, tkeep = tl.kernel_args(
        model, config, hidden, masks, temp, top_p, top_k, gumbel, greedy=greedy,
        forced_pad=None, allow=None, n_events=n_events, bar=bar)
    emb_net = model.net.embed_tokens.weight
    _build.check(emb_net, "event embedding", dtype,
                 (config.tokenizer.vocab_size, config.net.hidden_size))
    ev_acc = torch.empty((b, config.net.hidden_size), dtype=torch.float32, device=device)
    sptrs, sints, sfloats, xs, _, skeep = fs.kernel_args(
        fused, config.net, hidden, pools, lengths, lengths, cos.contiguous(),
        sin.contiguous(), page_size=page_size, pages_per_slot=pages_per_slot, bar=bar)
    _build.check(fused.final_norm, "final_norm", dtype, (config.net.hidden_size,))
    ptrs = (tptrs + [emb_net.data_ptr(), ev_acc.data_ptr()] + sptrs
            + [fused.final_norm.data_ptr()])
    name = "mm_event_loop_f32" if dtype == torch.float32 else "mm_event_loop_bf16"
    shape = _build.call_packed(name, ptrs, tints + sints + [n_events], tfloats + sfloats,
                               device)
    _build.count_launch("event_loop", shape)
    del tkeep, skeep
    return rows, rms_norm(xs, fused.final_norm, config.net.rms_norm_eps), pools


def _ragged_tables(index: torch.Tensor, n_events: int, capacity: int):
    """Each event's per-slot geometry [E, B]: positions ``index + e``,
    lengths clipped to the capacity, write positions clipped to its last
    row (the kernel gates them by the alive mask)."""
    pos = (index.to(torch.int32)[None, :]
           + torch.arange(n_events, dtype=torch.int32, device=index.device)[:, None])
    return (pos, pos.clamp(max=capacity).contiguous(),
            pos.clamp(0, capacity - 1).contiguous())


def decode_event_block_ragged_reference(model, config, fused: fs.FusedWeights,
                                        hidden: torch.Tensor, pools: fs.PagedPools,
                                        index: torch.Tensor, active: torch.Tensor,
                                        masks, temp, top_p, top_k,
                                        gumbel: Optional[torch.Tensor],
                                        allow: Optional[torch.Tensor] = None, *,
                                        n_events: int, greedy: bool, page_size: int,
                                        pages_per_slot: int):
    """The plain version of :func:`decode_event_block_ragged`: per event,
    the plain token row with ``forced_pad = ~alive``, :func:`event_embedding`,
    the plain whole step with ``active = alive`` and no append for retired
    slots, then the hidden frozen for them and the retirement rule."""
    capacity = pages_per_slot * page_size
    eos_id = config.tokenizer.eos_id
    active = active.to(device=hidden.device, dtype=torch.bool)
    alive = active.clone()
    pos, _, _ = _ragged_tables(index.to(hidden.device), n_events, capacity)
    rows = []
    for e in range(n_events):
        row, _ = tl.decode_token_row_reference(
            model, config, hidden, masks, temp, top_p, top_k,
            None if greedy else gumbel[e], greedy=greedy, forced_pad=~alive,
            allow=allow)
        h, pools = fs.fused_decode_step_reference(
            fused, config.net, event_embedding(model, row), pools, pos[e], alive,
            page_size=page_size, pages_per_slot=pages_per_slot,
            append_inactive=False)
        hidden = torch.where(alive[:, None], h, hidden.to(h.dtype))
        alive = alive & (row[:, 0] != eos_id) & (pos[e] + 1 < capacity)
        rows.append(row)
    hidden = torch.where(active[:, None], hidden, torch.zeros_like(hidden))
    return torch.stack(rows), hidden, pools


def decode_event_block_ragged(model, config, fused: fs.FusedWeights,
                              hidden: torch.Tensor, pools: fs.PagedPools,
                              index: torch.Tensor, active: torch.Tensor, masks,
                              temp, top_p, top_k, gumbel: Optional[torch.Tensor],
                              allow: Optional[torch.Tensor] = None, *,
                              n_events: int, greedy: bool, page_size: int,
                              pages_per_slot: int):
    """Decode up to ``n_events`` whole events for the continuous batcher's
    slots, with per-slot lengths and retirement.

    index int [B]: each slot's history length before the first event;
    active bool [B]: the slots occupied at entry; ``temp`` / ``top_p`` /
    ``top_k``: per-slot [B] (or scalars); gumbel [n_events, T*B, k_cap] f32
    (``sampling.slot_gumbel``; None when ``greedy``); allow [B, V] bool or
    None (no slot constrained).  The other arguments as
    :func:`decode_event_block`.  Returns (rows [n_events, B, T] int32 — pad
    rows after a slot retired —, hidden [B, D] after the final norm — a
    retired slot's from its last event, 0 for a slot inactive at entry —,
    pools updated in place).  CPU tensors run the plain version, CUDA
    tensors the kernel (one launch) or raise."""
    args = (model, config, fused, hidden, pools, index, active, masks, temp,
            top_p, top_k, gumbel, allow)
    kw = dict(n_events=n_events, greedy=greedy, page_size=page_size,
              pages_per_slot=pages_per_slot)
    tensors = [hidden, index, active, *masks, pools.k, pools.v, fused.wqkv,
               model.lm_head.weight]
    tensors += [t for t in (temp, top_p, top_k, gumbel, allow)
                if isinstance(t, torch.Tensor)]
    if _build.on_cpu(*tensors):
        return decode_event_block_ragged_reference(*args, **kw)

    b = hidden.shape[0]
    device = hidden.device
    capacity = pages_per_slot * page_size
    if n_events < 1:
        raise ValueError(f"ragged event loop: {n_events} events")
    problem = why_not_event_loop(config, b, capacity, pools.k.dtype)
    if problem:
        raise ValueError(problem)
    dtype = model.dtype
    if greedy:
        gumbel = None
    else:
        _build.check(gumbel, "gumbel", torch.float32,
                     (n_events, config.tokenizer.max_token_seq * b, gumbel.shape[-1]))
        gumbel = gumbel.view(-1, gumbel.shape[-1])
    _build.check(index, "index", torch.int32, (b,))
    alive = active.to(torch.uint8, copy=True).contiguous()
    _build.check(alive, "active", torch.uint8, (b,))
    pos, lengths, wpos = _ragged_tables(index, n_events, capacity)
    cos, sin = rope_cos_sin(pos, config.net.head_dim, config.net.rope_theta)
    bar = torch.zeros(2, dtype=torch.int32, device=device)
    tptrs, tints, tfloats, rows, _, tkeep = tl.kernel_args(
        model, config, hidden, masks, temp, top_p, top_k, gumbel, greedy=greedy,
        forced_pad=None, allow=allow, n_events=n_events, bar=bar)
    emb_net = model.net.embed_tokens.weight
    _build.check(emb_net, "event embedding", dtype,
                 (config.tokenizer.vocab_size, config.net.hidden_size))
    ev_acc = torch.empty((b, config.net.hidden_size), dtype=torch.float32, device=device)
    # the residual starts at zero: a slot dead at entry keeps it
    sptrs, sints, sfloats, xs, _, skeep = fs.kernel_args(
        fused, config.net, torch.zeros_like(hidden, dtype=dtype), pools, lengths, wpos,
        cos.contiguous(), sin.contiguous(), page_size=page_size,
        pages_per_slot=pages_per_slot, bar=bar)
    _build.check(fused.final_norm, "final_norm", dtype, (config.net.hidden_size,))
    ptrs = (tptrs + [emb_net.data_ptr(), ev_acc.data_ptr()] + sptrs
            + [fused.final_norm.data_ptr(), alive.data_ptr()])
    name = ("mm_event_loop_ragged_f32" if dtype == torch.float32
            else "mm_event_loop_ragged_bf16")
    shape = _build.call_packed(name, ptrs, tints + sints + [n_events], tfloats + sfloats,
                               device)
    _build.count_launch("event_loop_ragged", shape)
    del tkeep, skeep
    return rows, rms_norm(xs, fused.final_norm, config.net.rms_norm_eps), pools
