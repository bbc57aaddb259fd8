"""The training step, on one device or over a ``(data, model)`` mesh.

Counterpart of ``midi_model_tpu/train/trainer.py`` (its steps, full and
LoRA, with and without a mesh):

- AdamW (β 0.9/0.99, eps 1e-8 outside the square root) with no weight
  decay on the JAX layout's 1-D leaves (the final norms), a linear
  warmup→decay schedule and
  global-norm clipping, as an explicit chain in optax's order
  (:class:`Optimizer`);
- gradient accumulation over the ``[accum, B, L, T]`` microbatches, then one
  update;
- ``compute_dtype`` forward from f32 master weights: every f32 weight is
  cast once per forward except the embedding tables, whose gathered rows are
  cast (``MIDINet.embed_events``) — an explicit cast through
  ``torch.func.functional_call``, not ``torch.autocast``, whose per-op
  policy rounds elsewhere;
- cross-entropy ignoring pad, and masked token accuracy; ``token_chunk``
  runs the token net and the CE in chunks under ``torch.utils.checkpoint``.

The event net's causal attention trains through ``ops.attention``'s
autograd function: the CUDA forward and backward kernels on the card, their
plain versions on the CPU.  The step updates the master weights and the
moments IN PLACE (the JAX step donates its state).

On a mesh (``parallel.make_mesh``; one process a rank, each holding its
shard of the state, ``train.sharding``) the step is the JAX sharded step's:

- each data shard takes its rows of every microbatch; the loss is the
  global masked mean, so each microbatch's pad count is summed over the
  data group before the backward and the local nll sum divided by it;
- the model shards split both nets and the vocab (Megatron, with the
  autograd collectives of ``parallel.collectives``);
- after the accumulation the gradients are summed over the data group,
  flat in f32 buckets (:data:`BUCKET_ELEMENTS`); a LoRA step also sums its
  adapters' partial gradients over the model group;
- clipping takes the global norm: a split leaf's squares summed over the
  model group, a replicated leaf's counted once.

Recorder spans (``utils.profiling``): ``train.step`` (one optimizer step),
``train.microbatch`` (one forward and backward, attribute ``index``) and
``train.optimizer`` (the global norm, the update and its application).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from ..models.config import MIDIModelConfig, require_llama
from ..models.midinet import MIDINet, init_model
from ..parallel.mesh import Mesh
from ..utils import profiling
from .sched import linear_warmup_decay
from .sharding import apply_lora_sharded, lora_modules_split, split_axis, train_local_config

Params = Dict[str, torch.Tensor]

# the data group's gradient sum goes in f32 buckets of at most this many
# elements (256 MB)
BUCKET_ELEMENTS = 1 << 26


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: Params  # first moments
    nu: Params  # second moments


class TrainState(NamedTuple):
    step: int
    params: Params  # f32 master weights by the model's parameter names
    opt_state: AdamState


def _decays(name: str, p: torch.Tensor) -> bool:
    """The JAX trainer's ``_decay_mask``: weight decay on every leaf with
    ``ndim >= 2`` of ITS layout, where each net's per-layer weights — the
    layer norm scales too — are stacked on a leading layer axis.  So the
    decay skips only the two final norms (1-D there as here), not the
    per-layer norm scales that the reference's ``no_decay`` exempts.  LoRA
    factors (``[L, r, in]`` / ``[L, out, r]`` there) all decay."""
    return p.ndim >= 2 or ".layers." in name


class Optimizer:
    """The JAX trainer's optax chain, in its order: ``clip_by_global_norm``,
    ``scale_by_adam``, ``add_decayed_weights`` (masked), and
    ``scale_by_learning_rate`` of the schedule at the update count before
    this update."""

    def __init__(self, lr: float, weight_decay: float, warmup_steps: int,
                 total_steps: int, grad_clip: float, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-8):
        self.schedule = linear_warmup_decay(lr, warmup_steps, total_steps)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> AdamState:
        return AdamState(0, {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
                         {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params,
               g_norm: Optional[torch.Tensor] = None):
        """(updates, new state) for ``grads``; the moments update in place.
        ``g_norm``: the global gradient norm where ``grads`` are a shard's
        (:func:`global_norm`); by default theirs."""
        b1, b2 = self.b1, self.b2
        if g_norm is None:
            g_norm = global_norm(grads)
        clip = g_norm < self.grad_clip
        count = state.count + 1
        bc1 = 1.0 - np.float32(b1) ** np.float32(count)
        bc2 = 1.0 - np.float32(b2) ** np.float32(count)
        lr = self.schedule(state.count)
        updates = {}
        for name, g in grads.items():
            g = torch.where(clip, g, g / g_norm * self.grad_clip)
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + self.eps)
            if _decays(name, params[name]):
                u = u + self.weight_decay * params[name]
            updates[name] = u * -lr
        return updates, AdamState(count, state.mu, state.nu)


def global_norm(grads: Params, mesh: Optional[Mesh] = None, split=()) -> torch.Tensor:
    """The gradients' global L2 norm.  On a mesh, ``split`` names the leaves
    each model shard holds a block of: their squares are summed over the
    model group; every other leaf is whole on each shard and counts once."""
    def squares(names):
        return sum((torch.sum(grads[n].float() * grads[n].float()) for n in names),
                   torch.zeros((), device=next(iter(grads.values())).device))

    total = squares([n for n in grads if n not in split])
    parts = [n for n in grads if n in split]
    if parts:
        mine = squares(parts)
        if mesh is not None and mesh.tp > 1:
            dist.all_reduce(mine, op=dist.ReduceOp.SUM, group=mesh.model_group)
        total = total + mine
    return torch.sqrt(total)


def sum_over(grads: Params, group, bucket: int = BUCKET_ELEMENTS) -> None:
    """Sum ``grads`` (f32) over ``group`` in place: flat buckets of at most
    ``bucket`` elements, one all-reduce each."""
    if group is None or dist.get_world_size(group) == 1:
        return
    names = list(grads)
    while names:
        take, size = [], 0
        while names and (not take or size + grads[names[0]].numel() <= bucket):
            take.append(names.pop(0))
            size += grads[take[-1]].numel()
        flat = torch.cat([grads[n].reshape(-1) for n in take])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        at = 0
        for n in take:
            g = grads[n]
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 1_000_000,
                   grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(lr, weight_decay, warmup_steps, total_steps, grad_clip)


class _Method(nn.Module):
    """Runs one method of the model under ``functional_call``."""

    def __init__(self, model: MIDINet):
        super().__init__()
        self.model = model

    def forward(self, method: str, *args, **kwargs):
        return getattr(self.model, method)(*args, **kwargs)


def _structure(config: MIDIModelConfig) -> MIDINet:
    """The model's module tree without weights (the meta device): the
    trainer supplies every parameter to ``functional_call``."""
    return MIDINet(config, device="meta")


def compute_params(params: Params, compute_dtype) -> Params:
    """The forward's weights: f32 masters cast to ``compute_dtype``, except
    the embedding tables (their gathered rows are cast)."""
    return {n: p if "embed_tokens" in n or p.dtype != torch.float32 else p.to(compute_dtype)
            for n, p in params.items()}


def loss_fn(params: Params, config: MIDIModelConfig, batch: torch.Tensor,
            compute_dtype=torch.bfloat16, sample_positions: Optional[torch.Tensor] = None,
            remat: Union[bool, str] = False, token_chunk: Optional[int] = None,
            mesh: Optional[Mesh] = None):
    """Next-event token cross-entropy (mean over non-pad targets) and masked
    accuracy of ``batch [B, L, T]`` (the device of ``params``).

    ``sample_positions [N]`` restricts the token-net pass to those event
    positions; ``token_chunk`` runs the token net and the CE over chunks of
    event positions under ``torch.utils.checkpoint``, so the [N, 8, vocab]
    logits never exist whole (the backward recomputes each chunk).

    ``mesh``: ``params`` are this rank's shards (``train.sharding``) and
    ``batch`` its data shard's rows of the global batch; ``config`` is the
    global config.  The loss is the global masked mean: the nll sum, hits
    and pad count are summed over the data group (one all-reduce, outside
    the graph), and the returned loss is the local nll sum over the global
    count, whose gradients summed over the data group are the global
    loss's.  The metrics are the global ones.
    Returns (loss, {"loss", "acc"})."""
    pad_id = config.tokenizer.pad_id
    device = next(iter(params.values())).device
    batch = torch.as_tensor(batch, device=device).long()
    tp_group = mesh.model_group if mesh is not None and mesh.tp > 1 else None
    local = train_local_config(config, mesh.tp if tp_group is not None else 1)
    method = _Method(_structure(local))
    weights = {f"model.{n}": t for n, t in compute_params(params, compute_dtype).items()}

    def call(name, *args, **kwargs):
        return torch.func.functional_call(method, weights, (name, *args), kwargs)

    x, y = batch[:, :-1], batch[:, 1:]
    hidden, _ = call("forward", x, remat=remat, tp_group=tp_group)
    if sample_positions is not None:
        positions = torch.as_tensor(sample_positions, device=device).long()
        hidden, y = hidden[:, positions], y[:, positions]
    b, l, d = hidden.shape
    t = y.shape[-1]
    hidden = hidden.reshape(b * l, d)
    y = y.reshape(b * l, t)

    def chunk_stats(h_chunk, y_chunk):
        logits, _ = call("forward_token", h_chunk, y_chunk[:, :-1], remat=remat,
                         tp_group=tp_group)
        mask = (y_chunk != pad_id).float()
        logprobs = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logprobs, -1, y_chunk[..., None])[..., 0]
        hits = (logits.argmax(dim=-1) == y_chunk).float() * mask
        return (nll * mask).sum(), hits.sum(), mask.sum()

    n = b * l
    if token_chunk is None or token_chunk >= n:
        nll_sum, hit_sum, count = chunk_stats(hidden, y)
    else:
        main = n // token_chunk * token_chunk
        totals = [torch.zeros((), device=device) for _ in range(3)]
        for at in range(0, main, token_chunk):
            h_c, y_c = hidden[at:at + token_chunk], y[at:at + token_chunk]
            part = (torch.utils.checkpoint.checkpoint(chunk_stats, h_c, y_c, use_reentrant=False)
                    if torch.is_grad_enabled() else chunk_stats(h_c, y_c))
            totals = [a + p for a, p in zip(totals, part)]
        if main < n:
            totals = [a + p for a, p in zip(totals, chunk_stats(hidden[main:], y[main:]))]
        nll_sum, hit_sum, count = totals
    if mesh is not None and mesh.dp > 1:
        sums = torch.stack([nll_sum.detach(), hit_sum.detach(), count.detach()])
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.data_group)
        denom = torch.clamp(sums[2], min=1.0)
        return nll_sum / denom, {"loss": sums[0] / denom, "acc": sums[1] / denom}
    denom = torch.clamp(count, min=1.0)
    loss = nll_sum / denom
    acc = hit_sum / denom
    return loss, {"loss": loss, "acc": acc}


def _accumulated_step(state: TrainState, batch, accum_steps: int, optimizer: Optimizer,
                      loss_of, mesh: Optional[Mesh] = None, split=(),
                      model_summed=()) -> tuple:
    """One optimizer update of ``state.params`` from the microbatches of
    ``batch [accum_steps, B, L, T]``: ``loss_of(params, mb)`` -> (loss,
    metrics) differentiated per microbatch, the gradients summed, times
    ``1 / accum_steps``; the weights and moments update in place.  On a
    ``mesh``: the gradients summed over the data group, those of
    ``model_summed`` then over the model group, and the clipping norm taken
    over the mesh, ``split`` naming the leaves split over the model group
    (:func:`global_norm`)."""
    with profiling.span("train.step"):
        device = next(iter(state.params.values())).device
        batch = torch.as_tensor(batch, device=device)
        if batch.shape[0] != accum_steps:
            raise ValueError(f"batch of {batch.shape[0]} microbatches, "
                             f"accum_steps={accum_steps}")
        params = state.params
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        sums = {"loss": torch.zeros((), device=device), "acc": torch.zeros((), device=device)}
        for i, mb in enumerate(batch):
            with profiling.span("train.microbatch") as sp:
                if sp:
                    sp.attrs["index"] = i
                loss, metrics = loss_of(params, mb)
                loss.backward()
                sums = {k: v + metrics[k].detach() for k, v in sums.items()}
        scale = 1.0 / accum_steps
        grads = {n: p.grad * scale for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if mesh is not None:
            sum_over(grads, mesh.data_group)
            if model_summed and mesh.tp > 1:
                sum_over({n: grads[n] for n in model_summed}, mesh.model_group)
        with profiling.span("train.optimizer"):
            g_norm = None if mesh is None else global_norm(grads, mesh, split)
            updates, opt_state = optimizer.update(grads, state.opt_state, params, g_norm)
            with torch.no_grad():
                for n, p in params.items():
                    p.add_(updates[n])
        return (TrainState(state.step + 1, params, opt_state),
                {k: v * scale for k, v in sums.items()})


def make_train_step(config: MIDIModelConfig, optimizer: Optimizer, accum_steps: int = 1,
                    compute_dtype=torch.bfloat16, remat: Union[bool, str] = False,
                    token_chunk: Optional[int] = None, mesh: Optional[Mesh] = None):
    """``step(state, batch [accum_steps, B, L, T]) -> (state, metrics)``:
    the gradients of the microbatches summed, times ``1 / accum_steps``,
    then one optimizer update; metrics are the microbatches' means.
    ``remat``: False, True / "full", "dots" or "dots_all"
    (``models.llama.remat_policy``).  ``mesh``: ``state`` holds this rank's
    shards (``train.sharding.shard_params``, the moments alike) and
    ``batch`` its data shard's rows (``B`` = the global batch / dp)."""
    train_local_config(config, 1 if mesh is None else mesh.tp)  # raises early

    def loss_of(params, mb):
        return loss_fn(params, config, mb, compute_dtype, remat=remat, token_chunk=token_chunk,
                       mesh=mesh)

    def train_step(state: TrainState, batch):
        split = [n for n in state.params if split_axis(n) is not None]
        return _accumulated_step(state, batch, accum_steps, optimizer, loss_of, mesh, split)

    return train_step


def make_lora_train_step(config: MIDIModelConfig, optimizer: Optimizer,
                         lora_alpha: float = 128.0, accum_steps: int = 1,
                         compute_dtype=torch.bfloat16, remat: Union[bool, str] = False,
                         token_chunk: Optional[int] = None, mesh: Optional[Mesh] = None):
    """The LoRA fine-tune step, ``step(state, base_params, batch) -> (state,
    metrics)`` (the JAX trainer's ``make_lora_train_step``).  The adapters
    (``models.lora``) are the only leaves of ``state.params``, so the only
    ones the optimizer updates; the frozen base weights are a separate
    argument that requires no gradient and is never written.  Each
    microbatch differentiates ``loss_fn`` through ``apply_lora`` (W +
    (α/r)·B@A), so gradients reach only the (A, B) factors — through the
    attention kernels' autograd function on the card.

    ``mesh``: ``base_params`` are this rank's shards, the adapters are
    replicated (as the JAX sharded step replicates them), and each shard
    forms its block of the effective weights
    (``train.sharding.apply_lora_sharded``).  The adapters of split weights
    get partial gradients, summed over the model group after the data
    group's sum; then every adapter gradient is whole on every rank."""
    require_llama(config, "LoRA fine-tuning")
    train_local_config(config, 1 if mesh is None else mesh.tp)

    def train_step(state: TrainState, base_params: Params, batch):
        if any(p.requires_grad for p in base_params.values()):
            raise ValueError("the base weights of a LoRA step must not require grad")

        def loss_of(lora, mb):
            return loss_fn(apply_lora_sharded(base_params, lora, lora_alpha, mesh), config, mb,
                           compute_dtype, remat=remat, token_chunk=token_chunk, mesh=mesh)

        partial = [k for k, axis in lora_modules_split(state.params).items() if axis is not None]
        return _accumulated_step(state, batch, accum_steps, optimizer, loss_of, mesh,
                                 model_summed=partial)

    return train_step


def init_params(config: MIDIModelConfig, seed: int = 0, device=None) -> Params:
    """f32 master weights made from ``seed`` (``models.midinet.init_model``)."""
    model = init_model(config, seed=seed, dtype=torch.float32, device=device)
    return {n: p.detach() for n, p in model.named_parameters()}


def init_train_state(params: Params, optimizer: Optimizer) -> TrainState:
    """Step 0: f32 copies of ``params`` (the state's own: the steps update
    them in place) and zero moments."""
    params = {n: p.detach().to(torch.float32, copy=True).requires_grad_(True)
              for n, p in params.items()}
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


@torch.no_grad()
def eval_step(params: Params, config: MIDIModelConfig, batch, token_chunk: int = 256,
              mesh: Optional[Mesh] = None) -> dict:
    """Validation loss and masked accuracy (bf16 compute, as the JAX
    package's ``eval_step``), the token net in chunks of ``token_chunk``.
    ``mesh``: as ``loss_fn``'s, the metrics the global masked means over the
    data shards' rows."""
    _, metrics = loss_fn(params, config, batch, token_chunk=token_chunk, mesh=mesh)
    return metrics
