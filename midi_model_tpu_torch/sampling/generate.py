"""Batched autoregressive generation for the hierarchical MIDI model.

Counterpart of ``midi_model_tpu/sampling/generate.py``:

- :func:`prefill` embeds the prompt rows and runs the event net with causal
  attention, writing K/V into all-heads paged pools;
- :func:`decode_events` loops over events.  Each event samples an 8-token
  row (token net, shared head, grammar mask tables, top-p/top-k), embeds
  it, and runs one event-net step that attends over the pools and appends
  the new row.  ``ops.event_loop.decode_path`` picks how (by default the
  fused kernels for bf16 weights whose shapes they take, as the JAX
  package's ``usable`` rules without their TPU clauses):
  * the **event loop** — whole blocks of ``EVENTS_PER_LAUNCH`` (8) events as
    one launch each on bf16/f32 pools, and the pair for the rest of a chunk
    (its remainder, the rows near capacity);
  * the **pair** — one token-row launch (``ops.token_loop``) and one
    whole-step launch over all event-net layers (``ops.fused_step``) per
    event: every event on int8 pools, whose event loop the JAX package
    lacks too;
  * the **split** path — the token net step by step with the sampler
    kernel, then the per-layer ``decode_paged`` with the per-slot paged
    decode kernel — for everything else (fp32, GQA), and on request;
- a chunk stops at its end, when every row emits eos in the same event
  (per-event "end" state, the reference's quirk), or at capacity.

``tp_group`` makes the model one shard of a Megatron split
(``sampling.sharded``: the config is then the local one): the whole-step
and event-loop kernels cannot all-reduce between layers, so every event
takes the token-row kernel and then the split ``decode_paged`` with its
two all-reduces per layer — the JAX package's tensor-parallel step
(``generate.py:276-284``).  The token net is replicated and every model
shard draws the same noise, so every shard samples the same rows.

``kv_int8`` stores the event KV as int8 pages with per-token-per-head bf16
scales (``ops.paged_allheads``); with bf16 weights it takes the per-event
pair, whose whole step reads the int8 pools (``generate.py:303-313``'s
choice in the JAX package).

The loop runs eagerly from the host.  Every random draw comes from an
explicit ``torch.Generator`` on the generation device, one
``[T*B, K_CAP]`` Gumbel draw per event that both paths consume the same
way; greedy decode draws nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.config import MIDIModelConfig, require_llama
from ..models.midinet import MIDINet
from ..ops import event_loop, token_loop
from ..ops.fused_step import FusedWeights, fused_decode_step, prepare_fused
from ..ops.paged_allheads import PagedPools
from ..ops.sampler import per_row, sample_top_p_k
from ..ops.token_loop import decode_token_row, decode_token_row_reference
from .masks import MaskTable, build_mask_table
from .topk_topp import gumbel_rows

PAGE_SIZE = 64


class GenState(NamedTuple):
    """Decode state carried between events and chunks."""

    pools: PagedPools  # event-net KV, layer axis folded into pages
    hidden: torch.Tensor  # [B, D] hidden of the last consumed event row
    cur_len: int  # rows consumed so far (prompt + generated)
    all_eos: bool  # every row emitted eos in the same event


class Masks(NamedTuple):
    """A :class:`MaskTable` as bool tensors on the generation device."""

    first: torch.Tensor  # [V]
    steps: torch.Tensor  # [E, T, V]
    pad_only: torch.Tensor  # [V]


def mask_tensors(table: MaskTable, device) -> Masks:
    return Masks(*(torch.as_tensor(x, device=device)
                   for x in (table.first, table.steps, table.pad_only)))


def pages_per_slot(max_seq: int) -> int:
    """Pages per (layer, slot) for a capacity of ``max_seq`` rows, rounded
    up to a multiple of 4 like the JAX package (same pool layout)."""
    pps = -(-max_seq // PAGE_SIZE)
    return -(-pps // 4) * 4


def _device(model: MIDINet, device) -> torch.device:
    if device is None:
        return model.device
    device = torch.device(device)
    if device != model.device:
        raise ValueError(f"device {device} differs from the model's "
                         f"{model.device}")
    return device


@torch.no_grad()
def prefill(model: MIDINet, config: MIDIModelConfig, prompt, max_seq: int,
            kv_int8: bool = False, device=None, tp_group=None) -> GenState:
    """Run the event net over the prompt rows ``[B, P, T]``, writing the
    prompt KV directly into paged pools of capacity ``max_seq`` (rounded up
    to whole pages; int8 pages and scales with ``kv_int8``).  The JAX
    package embeds long prompts in 16-event chunks to bound TPU memory; the
    values are the same in one pass.  Under ``tp_group`` the pools hold
    this model shard's heads only.  A hybrid event net raises."""
    require_llama(config, "generate")
    device = _device(model, device)
    prompt = torch.as_tensor(np.asarray(prompt), device=device).long()
    b, p_len, _ = prompt.shape
    pps = pages_per_slot(max_seq)
    pools = model.net.alloc_storage(b, pps, PAGE_SIZE, kv_int8)
    hidden, pools = model.net.prefill_paged(
        model.embed_events(prompt), pools, page_size=PAGE_SIZE,
        pages_per_slot=pps, tp_group=tp_group)
    return GenState(pools=pools, hidden=hidden[:, -1], cur_len=p_len,
                    all_eos=False)


def _geometry(config: MIDIModelConfig, state: GenState):
    """(page_size, pages_per_slot) of the state's pools."""
    n_pages, ps, _ = state.pools.k.shape
    return ps, n_pages // (config.net.num_layers * state.hidden.shape[0])


def _decode_one_event(model: MIDINet, config: MIDIModelConfig,
                      state: GenState, masks: Masks, temp, top_p, top_k,
                      generator, greedy: bool, eos_possible: bool,
                      fused: Optional[FusedWeights], tp_group=None):
    """Sample one row (8 tokens) and advance the event cache by it; the
    fused path when ``fused`` (``prepare_fused`` of the event net) is given,
    else the split path (under ``tp_group`` with the token-row kernel where
    it takes the token net)."""
    b = state.hidden.shape[0]
    t_max = config.tokenizer.max_token_seq
    gumbel = None if greedy else gumbel_rows(b, t_max, generator)
    ps, pps = _geometry(config, state)
    if fused is not None:
        row, ended = decode_token_row(model, config, state.hidden, masks, temp,
                                      top_p, top_k, gumbel, greedy=greedy)
        emb = event_loop.event_embedding(model, row)
        index = torch.full((b,), state.cur_len, dtype=torch.int32,
                           device=state.hidden.device)
        hidden, pools = fused_decode_step(fused, config.net, emb, state.pools,
                                          index, page_size=ps,
                                          pages_per_slot=pps)
    else:
        if tp_group is not None and token_loop.kernel_limits(config, b) is None:
            row, ended = decode_token_row(model, config, state.hidden, masks, temp,
                                          top_p, top_k, gumbel, greedy=greedy)
        else:  # the token net step by step, each draw through the sampler kernel
            row, ended = decode_token_row_reference(
                model, config, state.hidden, masks, temp, top_p, top_k, gumbel,
                greedy=greedy, sample=sample_top_p_k)
        hidden, pools = model.net.decode_paged(  # one length: it picks the kernel
            model.embed_events(row[:, None, :])[:, 0], state.pools, state.cur_len,
            page_size=ps, pages_per_slot=pps, tp_group=tp_group)
    # the host reads `ended` only when eos can be sampled at all
    all_eos = eos_possible and bool(ended.all())
    return GenState(pools=pools, hidden=hidden, cur_len=state.cur_len + 1,
                    all_eos=all_eos), row


def _decode_event_block(model: MIDINet, config: MIDIModelConfig,
                        state: GenState, masks: Masks, temp, top_p, top_k,
                        generator, greedy: bool, eos_possible: bool,
                        fused: FusedWeights, n_events: int):
    """``n_events`` events in one event-loop launch, the noise drawn as the
    per-event path draws it.  An event where every row emits eos ends the
    block: its rows are kept, the later ones dropped (their appends lie
    beyond ``cur_len``, unread and overwritten by later appends).  Returns
    (state, rows [B, n_kept, T])."""
    b = state.hidden.shape[0]
    t_max = config.tokenizer.max_token_seq
    gumbel = None if greedy else torch.stack(
        [gumbel_rows(b, t_max, generator) for _ in range(n_events)])
    ps, pps = _geometry(config, state)
    rows, hidden, pools = event_loop.decode_event_block(
        model, config, fused, state.hidden, state.pools, state.cur_len, masks,
        temp, top_p, top_k, gumbel, n_events=n_events, greedy=greedy,
        page_size=ps, pages_per_slot=pps)
    n_kept, all_eos = n_events, False
    if eos_possible:
        ended = (rows[:, :, 0] == config.tokenizer.eos_id).all(dim=1).tolist()
        if any(ended):
            n_kept, all_eos = ended.index(True) + 1, True
    return GenState(pools=pools, hidden=hidden, cur_len=state.cur_len + n_kept,
                    all_eos=all_eos), rows[:n_kept].transpose(0, 1)


@torch.no_grad()
def decode_events(model: MIDINet, config: MIDIModelConfig, state: GenState,
                  masks: Masks, n_events_chunk: int, temp, top_p, top_k,
                  generator: Optional[torch.Generator], greedy: bool = False,
                  fused: Optional[bool] = None, tp_group=None):
    """Decode up to ``n_events_chunk`` rows.  Stops early once every row
    emitted eos in the same event, or the event cache is full.  Returns
    (state, rows [B, n_events_chunk, T] int32, n_done); rows beyond n_done
    are pad.  The pools are updated in place.

    ``fused`` and ``tp_group`` pick the path as ``ops.event_loop.
    decode_path`` does: True the fused kernels (which raise on shapes they
    cannot take; their plain versions, on CPU tensors, need an MHA event net
    with packed pages), False the split path, None by the rule."""
    b = state.hidden.shape[0]
    tokenizer = config.tokenizer
    device = state.hidden.device
    page_size, pps = _geometry(config, state)
    max_seq = page_size * pps
    path = event_loop.decode_path(config, model.dtype, b, max_seq, state.pools.quantized,
                                  fused, tp_group)
    weights = None if path == "split" else prepare_fused(model.net)
    temp = per_row(temp, b, torch.float32, device)
    top_p = per_row(top_p, b, torch.float32, device)
    top_k = per_row(top_k, b, torch.int32, device)
    rows = torch.full((b, n_events_chunk, tokenizer.max_token_seq),
                      tokenizer.pad_id, dtype=torch.int32, device=device)
    eos_possible = bool(masks.first[tokenizer.eos_id])
    knobs = (temp, top_p, top_k, generator, greedy, eos_possible, weights)
    e = event_loop.EVENTS_PER_LAUNCH if path == "event_loop" else 1
    step = 0
    while (step < n_events_chunk and not state.all_eos
           and state.cur_len < max_seq):
        if (e > 1 and step + e <= n_events_chunk
                and state.cur_len + e <= max_seq):
            state, block = _decode_event_block(model, config, state, masks,
                                               *knobs, e)
        else:
            state, row = _decode_one_event(model, config, state, masks, *knobs,
                                           tp_group=tp_group)
            block = row[:, None]
        rows[:, step:step + block.shape[1]] = block
        step += block.shape[1]
    return state, rows, step


def normalize_prompt(tokenizer, prompt: Optional[np.ndarray], batch_size: int,
                     max_token_seq: Optional[int] = None) -> np.ndarray:
    """Reference prompt normalization: tile to batch, clip/pad rows to
    ``max_token_seq``; the default prompt is a lone bos row."""
    t_max = max_token_seq or tokenizer.max_token_seq
    if prompt is None:
        out = np.full((batch_size, 1, t_max), tokenizer.pad_id, dtype=np.int64)
        out[:, 0, 0] = tokenizer.bos_id
        return out
    prompt = np.asarray(prompt)
    if prompt.ndim == 2:
        prompt = np.repeat(prompt[None], batch_size, axis=0)
    elif prompt.shape[0] == 1:
        prompt = np.repeat(prompt, batch_size, axis=0)
    elif prompt.ndim != 3 or prompt.shape[0] != batch_size:
        raise ValueError(f"invalid shape for prompt, {prompt.shape}")
    prompt = prompt[..., :t_max]
    if prompt.shape[-1] < t_max:
        prompt = np.pad(prompt, ((0, 0), (0, 0), (0, t_max - prompt.shape[-1])),
                        mode="constant", constant_values=tokenizer.pad_id)
    return prompt.astype(np.int64)


@torch.no_grad()
def generate(model: MIDINet, config: MIDIModelConfig,
             prompt: Optional[np.ndarray] = None, batch_size: int = 1,
             max_len: int = 512, temp: float = 1.0, top_p: float = 0.98,
             top_k: int = 20, seed: int = 0, greedy: bool = False,
             disable_patch_change: bool = False,
             disable_control_change: bool = False,
             disable_channels: Optional[list] = None,
             chunk_size: Optional[int] = None, context_limit: int = 4096,
             kv_int8: bool = False, event_callback=None,
             device=None, fused: Optional[bool] = None,
             tp_group=None) -> np.ndarray:
    """Host-facing generation: returns ``[B, L, T]`` int numpy rows (prompt +
    generated), like the JAX package's ``generate``.

    ``device`` defaults to the model's.  Sampling draws come from one
    ``torch.Generator`` on that device seeded with ``seed``, so the output is
    reproducible on one device and independent of ``chunk_size``; it is not
    the JAX package's draw for the same seed.  ``event_callback(rows)``
    receives each decoded chunk as numpy.  ``fused`` picks the decode path
    as in :func:`decode_events`; ``kv_int8`` stores int8 pools; ``tp_group``
    runs a model shard (``sampling.sharded.generate_tp``)."""
    device = _device(model, device)
    tokenizer = config.tokenizer
    prompt = normalize_prompt(tokenizer, prompt, batch_size)
    # only the model-visible window is truncated; the dropped head is
    # re-prepended to the returned sequence
    head = prompt[:, : max(0, prompt.shape[1] - context_limit)]
    prompt = prompt[:, -context_limit:]
    _, p_len, _ = prompt.shape
    if p_len >= max_len:
        return np.concatenate([head, prompt], axis=1) if head.shape[1] else prompt

    table = build_mask_table(
        tokenizer, disable_patch_change=disable_patch_change,
        disable_control_change=disable_control_change,
        disable_channels=disable_channels)
    masks = mask_tensors(table, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    remaining = max_len - p_len
    chunk = chunk_size or remaining
    state = prefill(model, config, prompt, max_len, kv_int8=kv_int8, device=device,
                    tp_group=tp_group)
    pieces = [head, prompt] if head.shape[1] else [prompt]
    produced = 0
    while produced < remaining:
        n = min(chunk, remaining - produced)
        state, rows, n_done = decode_events(model, config, state, masks, n,
                                            temp, top_p, top_k, generator,
                                            greedy=greedy, fused=fused,
                                            tp_group=tp_group)
        if n_done:
            rows_np = rows[:, :n_done].cpu().numpy().astype(np.int64)
            pieces.append(rows_np)
            if event_callback is not None:
                event_callback(rows_np)
        produced += n
        if state.all_eos or n_done < n:
            break
    return np.concatenate(pieces, axis=1)
