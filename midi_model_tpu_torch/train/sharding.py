"""Training's tensor-parallel split: which weight each model shard holds.

Counterpart of the JAX package's ``param_specs``, ``shard_params`` and
``shard_train_state`` (``midi_model_tpu/parallel/mesh.py``).  Under
training's tp the split covers more than serving's
(``sampling.sharded.tp_shard_params``, the event net only):

- **both** nets: q/k/v, gate and up column-parallel (a shard keeps its
  rows of the torch ``[out, in]`` matrix: its heads, its MLP slice),
  o_proj and down row-parallel (its columns);
- ``lm_head`` over the vocab (its rows; ``MIDINet.logits`` gathers the
  logits);
- the embeddings and the norms replicated.

A shard is a contiguous block in model-rank order.  The JAX package splits
the flattened ``H*Dh`` axis and lets XLA reshard; the port splits by heads,
so tp must divide both nets' heads (:func:`train_local_config` raises
otherwise), and the vocab, as the JAX package's ``device_put`` requires.
The optimizer's moments take their weights' split.  :func:`gather_params`
joins the shards back into the single-device layout, the one checkpoints
and exports are written in, so a run resumes on any mesh shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..models.config import MIDIModelConfig, require_llama
from ..parallel.mesh import Mesh
from ..sampling.sharded import COLUMN_PARALLEL, ROW_PARALLEL, tp_local_net

Params = Dict[str, torch.Tensor]


def split_axis(name: str) -> Optional[int]:
    """The axis of weight ``name`` (the model's parameter names) that tp
    splits: 0 for the column-parallel matrices and ``lm_head`` (its vocab
    rows), 1 for the row-parallel ones; None for a replicated weight (and
    for a LoRA factor: adapters are replicated)."""
    if name == "lm_head.weight":
        return 0
    parts = name.split(".")
    if ".layers." not in name or parts[-1] != "weight":
        return None
    if parts[-2] in COLUMN_PARALLEL:
        return 0
    if parts[-2] in ROW_PARALLEL:
        return 1
    return None


def train_local_config(config: MIDIModelConfig, tp: int) -> MIDIModelConfig:
    """One model shard's view of ``config`` under training's split: both
    nets' heads, kv heads and MLP widths divided by ``tp``, the head dims
    pinned.  The vocab's split is the ``lm_head`` weight's shape (the config
    keeps the tokenizer's vocab, which the embeddings and the grammar masks
    use).  Raises where ``tp`` does not divide a net's heads or the vocab,
    and for a hybrid event net, which no trainer takes."""
    require_llama(config, "training")
    if tp == 1:
        return config
    nets = {field: tp_local_net(getattr(config, field), tp, field)
            for field in ("net", "net_token")}
    vocab = config.tokenizer.vocab_size
    if vocab % tp:
        raise ValueError(f"tp={tp} must divide the vocab ({vocab}): lm_head is split over it")
    return dataclasses.replace(config, **nets)


def _tp(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.tp


def shard_params(params: Params, mesh: Optional[Mesh]) -> Params:
    """This model shard's block of each split weight (a copy), every other
    weight as it is."""
    tp = _tp(mesh)
    if tp == 1:
        return dict(params)
    out = {}
    for name, p in params.items():
        axis = split_axis(name)
        if axis is not None:
            width = p.shape[axis] // tp
            p = p.narrow(axis, mesh.model_rank * width, width).contiguous()
        out[name] = p
    return out


@torch.no_grad()
def gather_params(local: Params, mesh: Optional[Mesh]) -> Params:
    """The single-device layout of a shard's weights: each split weight's
    blocks joined over the model group (every model shard must call it, in
    the same order), every other weight as it is."""
    tp = _tp(mesh)
    if tp == 1:
        return dict(local)
    out = {}
    for name, p in local.items():
        axis = split_axis(name)
        if axis is not None:
            p = p.detach().contiguous()
            parts = [torch.empty_like(p) for _ in range(tp)]
            dist.all_gather(parts, p, group=mesh.model_group)
            p = torch.cat(parts, dim=axis)
        out[name] = p
    return out


def lora_modules_split(lora: Params) -> Dict[str, Optional[int]]:
    """Each adapter key's module weight's split axis (``split_axis`` of
    ``<module>.weight``): the adapters of a split weight get partial
    gradients on each shard (:func:`apply_lora_sharded`)."""
    return {k: split_axis(k.rsplit(".lora_", 1)[0] + ".weight") for k in lora}


def apply_lora_sharded(base: Params, lora: Params, alpha: float,
                       mesh: Optional[Mesh]) -> Params:
    """``models.lora.apply_lora`` on a model shard: replicated adapters
    over this shard's base weights.  A shard forms only its block of W +
    (α/r)·B@A: B's rows for a column-parallel weight, A's columns for a
    row-parallel one.  So each adapter of a split weight gets a partial
    gradient here; the trainer sums it over the model group."""
    from ..models.lora import apply_lora

    tp = _tp(mesh)
    if tp == 1:
        return apply_lora(base, lora, alpha)
    local = {}
    for key, axis in lora_modules_split(lora).items():
        t = lora[key]
        if axis == 0 and key.endswith(".lora_B.weight"):
            width = t.shape[0] // tp
            t = t[mesh.model_rank * width:(mesh.model_rank + 1) * width]
        elif axis == 1 and key.endswith(".lora_A.weight"):
            width = t.shape[1] // tp
            t = t[:, mesh.model_rank * width:(mesh.model_rank + 1) * width]
        local[key] = t
    return apply_lora(base, local, alpha)
