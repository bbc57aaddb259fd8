"""Batched autoregressive generation for the hierarchical MIDI model.

Counterpart of ``midi_model_tpu/sampling/generate.py`` on its split path
(per-event token scan + per-layer event-net step; the JAX package's fused
``token_loop`` / ``fused_step`` / ``event_loop`` kernels are not ported):

- :func:`prefill` embeds the prompt rows and runs the event net with causal
  attention, writing K/V into all-heads paged pools;
- :func:`decode_events` loops over events: :func:`token_row_scan` samples
  an 8-token row with the token net, the shared head, the grammar mask
  tables and top-p/top-k; one paged event-net step then attends over the
  pools and appends the new row;
- a chunk stops at its end, when every row emits eos in the same event
  (per-event "end" state, the reference's quirk), or at capacity.

The loop runs eagerly from the host.  Every random draw comes from an
explicit ``torch.Generator`` on the generation device; greedy decode draws
nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.config import MIDIModelConfig
from ..models.llama import DenseCache
from ..models.midinet import MIDINet
from ..ops.paged_allheads import PagedPools, alloc_pools
from .masks import MaskTable, build_mask_table
from .topk_topp import gumbel_noise, per_row, sample_greedy, sample_top_p_k

PAGE_SIZE = 64


class GenState(NamedTuple):
    """Decode state carried between events and chunks."""

    pools: PagedPools  # event-net KV, layer axis folded into pages
    hidden: torch.Tensor  # [B, D] hidden of the last consumed event row
    cur_len: int  # rows consumed so far (prompt + generated)
    all_eos: bool  # every row emitted eos in the same event

    def capacity(self, config: MIDIModelConfig, batch: int) -> int:
        n_pages, ps, _ = self.pools.k.shape
        return (n_pages // (config.net.num_layers * batch)) * ps


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
            kv_int8: bool = False, device=None) -> GenState:
    """Run the event net over the prompt rows ``[B, P, T]``, writing the
    prompt KV directly into paged pools of capacity ``max_seq`` (rounded up
    to whole pages).  The JAX package embeds long prompts in 16-event
    chunks to bound TPU memory; the values are the same in one pass."""
    if kv_int8:
        raise NotImplementedError("int8 KV pools are not ported yet")
    device = _device(model, device)
    prompt = torch.as_tensor(np.asarray(prompt), device=device).long()
    b, p_len, _ = prompt.shape
    net = config.net
    pps = pages_per_slot(max_seq)
    pools = alloc_pools(net.kv_heads, net.num_layers * b * pps, PAGE_SIZE,
                        net.head_dim, model.dtype, device)
    hidden, pools = model.net.prefill_paged(
        model.embed_events(prompt), pools, page_size=PAGE_SIZE,
        pages_per_slot=pps)
    return GenState(pools=pools, hidden=hidden[:, -1], cur_len=p_len,
                    all_eos=False)


@torch.no_grad()
def token_row_scan(model: MIDINet, config: MIDIModelConfig,
                   hidden: torch.Tensor, masks: Masks, temp, top_p, top_k,
                   generator: Optional[torch.Generator], greedy: bool):
    """Decode one full token row per batch row.

    hidden [B, D]: event-net hidden.  ``temp``/``top_p``/``top_k`` are
    scalars or per-row [B].  Each sampled step draws Gumbel noise [B, K_CAP]
    from ``generator``.  Returns (row [B, T] int32, ended [B] bool — eos
    emitted at step 0)."""
    tok_cfg = config.net_token
    tokenizer = config.tokenizer
    b = hidden.shape[0]
    device = hidden.device
    t_max = tokenizer.max_token_seq
    eos_id = tokenizer.eos_id
    first_event_id = eos_id + 1
    n_events = len(tokenizer.events)
    temp_b = per_row(temp, b, torch.float32, device)[:, None]
    top_p = per_row(top_p, b, torch.float32, device)
    top_k = per_row(top_k, b, torch.int32, device)

    cache = DenseCache.zeros(tok_cfg, b, t_max, model.dtype, device)
    prev = None
    ended = torch.zeros((b,), dtype=torch.bool, device=device)
    e_off = torch.zeros((b,), dtype=torch.long, device=device)
    toks = []
    for i in range(t_max):
        inp = (hidden.to(model.dtype) if i == 0
               else model.net_token.embed_tokens(prev.long()))
        h, cache = model.net_token(inp[:, None, :], cache)
        probs = torch.softmax(model.logits(h[:, 0]) / temp_b, dim=-1)
        mask = masks.first[None, :] if i == 0 else masks.steps[e_off, i]
        mask = torch.where(ended[:, None], masks.pad_only[None, :], mask)
        probs = probs * mask
        if greedy:
            tok = sample_greedy(probs)
        else:
            tok = sample_top_p_k(probs, top_p, top_k,
                                 gumbel_noise(b, generator))
        if i == 0:
            ended = tok == eos_id
            e_off = (tok.long() - first_event_id).clamp(0, n_events - 1)
        prev = tok
        toks.append(tok)
    return torch.stack(toks, dim=1), ended


def _decode_one_event(model: MIDINet, config: MIDIModelConfig,
                      state: GenState, masks: Masks, temp, top_p, top_k,
                      generator, greedy: bool, eos_possible: bool):
    """Sample one row (8 tokens) and advance the event cache by it."""
    b = state.hidden.shape[0]
    row, ended = token_row_scan(model, config, state.hidden, masks, temp,
                                top_p, top_k, generator, greedy)
    emb = model.embed_events(row[:, None, :])[:, 0]
    n_pages, ps, _ = state.pools.k.shape
    pps = n_pages // (config.net.num_layers * b)
    index = torch.full((b,), state.cur_len, dtype=torch.int32,
                       device=row.device)
    hidden, pools = model.net.decode_paged(emb, state.pools, index,
                                           page_size=ps, pages_per_slot=pps)
    # the host reads `ended` only when eos can be sampled at all
    all_eos = eos_possible and bool(ended.all())
    return GenState(pools=pools, hidden=hidden, cur_len=state.cur_len + 1,
                    all_eos=all_eos), row


@torch.no_grad()
def decode_events(model: MIDINet, config: MIDIModelConfig, state: GenState,
                  masks: Masks, n_events_chunk: int, temp, top_p, top_k,
                  generator: Optional[torch.Generator], greedy: bool = False):
    """Decode up to ``n_events_chunk`` rows.  Stops early once every row
    emitted eos in the same event, or the event cache is full.  Returns
    (state, rows [B, n_events_chunk, T] int32, n_done); rows beyond n_done
    are pad.  The pools are updated in place."""
    b = state.hidden.shape[0]
    tokenizer = config.tokenizer
    max_seq = state.capacity(config, b)
    rows = torch.full((b, n_events_chunk, tokenizer.max_token_seq),
                      tokenizer.pad_id, dtype=torch.int32,
                      device=state.hidden.device)
    eos_possible = bool(masks.first[tokenizer.eos_id])
    step = 0
    while (step < n_events_chunk and not state.all_eos
           and state.cur_len < max_seq):
        state, row = _decode_one_event(model, config, state, masks, temp,
                                       top_p, top_k, generator, greedy,
                                       eos_possible)
        rows[:, step] = row
        step += 1
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
             device=None) -> np.ndarray:
    """Host-facing generation: returns ``[B, L, T]`` int numpy rows (prompt +
    generated), like the JAX package's ``generate``.

    ``device`` defaults to the model's.  Sampling draws come from one
    ``torch.Generator`` on that device seeded with ``seed``, so the output is
    reproducible on one device and independent of ``chunk_size``; it is not
    the JAX package's draw for the same seed.  ``event_callback(rows)``
    receives each decoded chunk as numpy."""
    if kv_int8:
        raise NotImplementedError("int8 KV pools are not ported yet")
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
    state = prefill(model, config, prompt, max_len, device=device)
    pieces = [head, prompt] if head.shape[1] else [prompt]
    produced = 0
    while produced < remaining:
        n = min(chunk, remaining - produced)
        state, rows, n_done = decode_events(model, config, state, masks, n,
                                            temp, top_p, top_k, generator,
                                            greedy=greedy)
        if n_done:
            rows_np = rows[:, :n_done].cpu().numpy().astype(np.int64)
            pieces.append(rows_np)
            if event_callback is not None:
                event_callback(rows_np)
        produced += n
        if state.all_eos or n_done < n:
            break
    return np.concatenate(pieces, axis=1)
