"""Multi-device generation over a ``(data, model)`` mesh (``parallel.mesh``).

Counterpart of ``midi_model_tpu/sampling/sharded.py``.  Every rank is one
process running this same host program (SPMD); there is no global array.

- **Data axis** (:func:`generate_dp`): each data shard decodes its own rows
  of the batch with the unchanged single-device program — fused kernels,
  event loops, paged pools — and nothing crosses devices in the loop.
  After each chunk the host gathers every shard's rows over the gloo host
  group, so every rank returns the whole batch in global order.  Shard
  ``i`` draws from a generator seeded with :func:`shard_seed` ``(seed,
  i)``, so its rows are exactly single-device ``generate`` on its prompt
  rows with that seed (the JAX package folds the shard index into its key).
- **Model axis** (:func:`generate_tp`): Megatron, as the JAX package's
  model axis.  q/k/v, gate and up are column-parallel (a rank keeps its
  heads and its slice of the MLP), o_proj and down row-parallel with one
  all-reduce each per layer (``models.llama.LlamaLayer.finish``).  The
  token net, the embeddings and ``lm_head`` are replicated, and every
  model shard draws the same noise, so every shard samples the same rows.
  The event net takes the split step (token-row kernel, then
  ``decode_paged``): the whole-step and event-loop kernels cannot
  all-reduce between layers.

Each rank's paged pools hold only its heads: exactly the single-device
layout at the local head count (:func:`tp_local_config`), int8 scale rows
included.  The JAX package's ``alloc_pools(shards=)`` lays out one global
lane-sharded array with a scale row per shard; a rank here allocates its
own pools, so it needs no such argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.config import MIDIModelConfig, TransformerConfig
from ..models.midinet import MIDINet
from ..parallel.mesh import Mesh, gather_shards
from .generate import (GenState, Masks, decode_events, generate, mask_tensors,
                       normalize_prompt, prefill)
from .masks import build_mask_table

# the event net's Megatron split: output rows (column-parallel) and input
# columns (row-parallel) of the torch [out, in] matrices
COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_PARALLEL = ("o_proj", "down_proj")


def shard_seed(seed: int, shard: int) -> int:
    """The seed of data shard ``shard``'s generator: ``seed`` itself for
    shard 0, else the first 32-bit word of ``SeedSequence([seed, shard])``."""
    if shard == 0:
        return seed
    return int(np.random.SeedSequence([seed, shard]).generate_state(1)[0])


def _data_rows(mesh: Mesh, batch: int) -> slice:
    """This data shard's rows of a global batch of ``batch``."""
    if batch % mesh.dp:
        raise ValueError(f"batch_size {batch} not divisible by dp={mesh.dp}")
    local = batch // mesh.dp
    return slice(mesh.data_rank * local, (mesh.data_rank + 1) * local)


def prefill_dp(model: MIDINet, config: MIDIModelConfig, prompt, max_seq: int,
               mesh: Mesh, kv_int8: bool = False) -> GenState:
    """This data shard's prefill of the global ``prompt [B, P, T]`` (B
    divisible by dp): the state of its own rows."""
    prompt = np.asarray(prompt)
    return prefill(model, config, prompt[_data_rows(mesh, prompt.shape[0])], max_seq,
                   kv_int8=kv_int8)


def decode_events_dp(model: MIDINet, config: MIDIModelConfig, state: GenState,
                     masks: Masks, n_events_chunk: int, temp, top_p, top_k,
                     generator: Optional[torch.Generator], mesh: Mesh,
                     greedy: bool = False):
    """One decode chunk of this data shard's rows (``generator``: its own,
    seeded by :func:`shard_seed`), then the rows of every shard gathered.
    Returns (state, rows [B, n_events_chunk, T] numpy int32 in global order,
    n_done [dp], all_eos [dp]); a shard's rows beyond its n_done are pad."""
    state, rows, n_done = decode_events(model, config, state, masks, n_events_chunk,
                                        temp, top_p, top_k, generator, greedy=greedy)
    rows = gather_shards(mesh, rows.cpu().numpy())
    flags = gather_shards(mesh, np.asarray([[n_done, state.all_eos]], np.int64))
    return state, rows, flags[:, 0], flags[:, 1].astype(bool)


@torch.no_grad()
def generate_dp(model: MIDINet, config: MIDIModelConfig, mesh: Mesh,
                prompt: Optional[np.ndarray] = None, batch_size: int = 32,
                max_len: int = 512, temp: float = 1.0, top_p: float = 0.98,
                top_k: int = 20, seed: int = 0, greedy: bool = False,
                disable_patch_change: bool = False,
                disable_control_change: bool = False,
                disable_channels: Optional[list] = None,
                chunk_size: Optional[int] = None, context_limit: int = 4096,
                kv_int8: bool = False, event_callback=None) -> np.ndarray:
    """``generate`` over the data axis: the global ``batch_size`` (divisible
    by dp) split into contiguous shards, one per data shard, each decoded
    with the full model (the model axis, if any, repeats it).  Returns the
    whole ``[B, L, T]`` batch on every rank; rows of a shard that finished
    before the others are pad.  ``event_callback`` receives each chunk's
    rows of the whole batch."""
    tokenizer = config.tokenizer
    prompt = normalize_prompt(tokenizer, prompt, batch_size)
    head = prompt[:, : max(0, prompt.shape[1] - context_limit)]
    prompt = prompt[:, -context_limit:]
    p_len = prompt.shape[1]
    if p_len >= max_len:
        return np.concatenate([head, prompt], axis=1) if head.shape[1] else prompt

    table = build_mask_table(
        tokenizer, disable_patch_change=disable_patch_change,
        disable_control_change=disable_control_change,
        disable_channels=disable_channels)
    masks = mask_tensors(table, model.device)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(shard_seed(seed, mesh.data_rank))

    remaining = max_len - p_len
    chunk = chunk_size or remaining
    state = prefill_dp(model, config, prompt, max_len, mesh, kv_int8=kv_int8)
    pieces = [head, prompt] if head.shape[1] else [prompt]
    produced = 0
    while produced < remaining:
        n = min(chunk, remaining - produced)
        state, rows, n_done, all_eos = decode_events_dp(
            model, config, state, masks, n, temp, top_p, top_k, generator, mesh,
            greedy=greedy)
        n_max = int(n_done.max())
        if n_max:
            rows = rows[:, :n_max].astype(np.int64)
            pieces.append(rows)
            if event_callback is not None:
                event_callback(rows)
        produced += n
        if all_eos.all() or n_max < n:
            break
    return np.concatenate(pieces, axis=1)


# ---- the model axis -------------------------------------------------------

def tp_local_net(net: TransformerConfig, tp: int, what: str = "net") -> TransformerConfig:
    """One model shard's view of a stack: heads, kv heads and the MLP width
    divided by ``tp``, the head dim pinned (the hidden width stays global).
    Raises where ``tp`` does not divide them (``what`` names the stack)."""
    if net.num_heads % tp or net.kv_heads % tp or net.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide the {what} heads ({net.num_heads}), "
                         f"kv heads ({net.kv_heads}) and intermediate "
                         f"({net.intermediate_size})")
    return dataclasses.replace(net, num_heads=net.num_heads // tp,
                               num_kv_heads=net.kv_heads // tp,
                               intermediate_size=net.intermediate_size // tp,
                               head_dim_override=net.head_dim)


def tp_local_config(config: MIDIModelConfig, tp: int) -> MIDIModelConfig:
    """The per-shard view of the event net (:func:`tp_local_net`); the token
    net stays global."""
    return dataclasses.replace(config, net=tp_local_net(config.net, tp))


@torch.no_grad()
def tp_shard_params(source, mesh: Mesh, config: Optional[MIDIModelConfig] = None,
                    dtype: Optional[torch.dtype] = None) -> MIDINet:
    """This model shard's :class:`MIDINet` under :func:`tp_local_config`, on
    ``mesh.device``: the rank's rows of the column-parallel and columns of
    the row-parallel event-net matrices, every other weight whole.
    ``source``: a full ``MIDINet`` (its config and dtype by default) or a
    reference-layout state dict (``config`` required; f32 by default)."""
    if isinstance(source, MIDINet):
        config = source.config
        dtype = dtype or source.dtype
        full = source.state_dict()
    else:
        if config is None:
            raise ValueError("a state dict needs its config")
        dtype = dtype or torch.float32
        full = {k: torch.as_tensor(np.asarray(v)) for k, v in source.items()}
    model = MIDINet(tp_local_config(config, mesh.tp), dtype=dtype, device=mesh.device)
    m = mesh.model_rank
    local = {}
    for name, p in model.state_dict().items():
        w = full[name]
        kind = name.split(".")[-2]
        if name.startswith("net.layers.") and kind in COLUMN_PARALLEL:
            w = w[m * p.shape[0]:(m + 1) * p.shape[0]]
        elif name.startswith("net.layers.") and kind in ROW_PARALLEL:
            w = w[:, m * p.shape[1]:(m + 1) * p.shape[1]]
        local[name] = w
    model.load_state_dict(local)
    return model


def prefill_tp(model: MIDINet, config: MIDIModelConfig, prompt, max_seq: int,
               mesh: Mesh, kv_int8: bool = False) -> GenState:
    """Tensor-parallel prefill of the whole batch: ``model`` is this rank's
    shard (:func:`tp_shard_params`), ``config`` the global one; the pools
    hold this shard's heads."""
    return prefill(model, tp_local_config(config, mesh.tp), prompt, max_seq,
                   kv_int8=kv_int8, tp_group=mesh.model_group)


def decode_events_tp(model: MIDINet, config: MIDIModelConfig, state: GenState,
                     masks: Masks, n_events_chunk: int, temp, top_p, top_k,
                     generator: Optional[torch.Generator], mesh: Mesh,
                     greedy: bool = False):
    """Tensor-parallel decode chunk (``decode_events`` on the split path
    with the model group); the rows are the same on every model shard."""
    return decode_events(model, tp_local_config(config, mesh.tp), state, masks,
                         n_events_chunk, temp, top_p, top_k, generator, greedy=greedy,
                         tp_group=mesh.model_group)


def generate_tp(model: MIDINet, config: MIDIModelConfig, mesh: Mesh,
                prompt: Optional[np.ndarray] = None, batch_size: int = 32,
                **kw) -> np.ndarray:
    """Tensor-parallel ``generate`` (``model``: this rank's shard from
    :func:`tp_shard_params`; ``config``: the global config; the other
    arguments as ``generate``'s, int8 pools included).  Every rank returns
    the same rows."""
    return generate(model, tp_local_config(config, mesh.tp), prompt=prompt,
                    batch_size=batch_size, tp_group=mesh.model_group, **kw)
