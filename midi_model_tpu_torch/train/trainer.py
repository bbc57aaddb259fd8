"""The training step on one device.

Counterpart of ``midi_model_tpu/train/trainer.py`` (its single-device
steps, full and LoRA; the data/tensor-parallel variants wait for the
multi-device port):

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
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..models.config import MIDIModelConfig
from ..models.midinet import MIDINet, init_model
from .sched import linear_warmup_decay

Params = Dict[str, torch.Tensor]


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
    def update(self, grads: Params, state: AdamState, params: Params):
        """(updates, new state) for ``grads``; the moments update in place."""
        b1, b2 = self.b1, self.b2
        g_norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads.values()))
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
            remat: Union[bool, str] = False, token_chunk: Optional[int] = None):
    """Next-event token cross-entropy (mean over non-pad targets) and masked
    accuracy of ``batch [B, L, T]`` (the device of ``params``).

    ``sample_positions [N]`` restricts the token-net pass to those event
    positions; ``token_chunk`` runs the token net and the CE over chunks of
    event positions under ``torch.utils.checkpoint``, so the [N, 8, vocab]
    logits never exist whole (the backward recomputes each chunk).
    Returns (loss, {"loss", "acc"})."""
    pad_id = config.tokenizer.pad_id
    device = next(iter(params.values())).device
    batch = torch.as_tensor(batch, device=device).long()
    method = _Method(_structure(config))
    weights = {f"model.{n}": t for n, t in compute_params(params, compute_dtype).items()}

    def call(name, *args, **kwargs):
        return torch.func.functional_call(method, weights, (name, *args), kwargs)

    x, y = batch[:, :-1], batch[:, 1:]
    hidden, _ = call("forward", x, remat=remat)
    if sample_positions is not None:
        positions = torch.as_tensor(sample_positions, device=device).long()
        hidden, y = hidden[:, positions], y[:, positions]
    b, l, d = hidden.shape
    t = y.shape[-1]
    hidden = hidden.reshape(b * l, d)
    y = y.reshape(b * l, t)

    def chunk_stats(h_chunk, y_chunk):
        logits, _ = call("forward_token", h_chunk, y_chunk[:, :-1], remat=remat)
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
    denom = torch.clamp(count, min=1.0)
    loss = nll_sum / denom
    acc = hit_sum / denom
    return loss, {"loss": loss, "acc": acc}


def _accumulated_step(state: TrainState, batch, accum_steps: int, optimizer: Optimizer,
                      loss_of) -> tuple:
    """One optimizer update of ``state.params`` from the microbatches of
    ``batch [accum_steps, B, L, T]``: ``loss_of(params, mb)`` -> (loss,
    metrics) differentiated per microbatch, the gradients summed, times
    ``1 / accum_steps``; the weights and moments update in place."""
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
    for mb in batch:
        loss, metrics = loss_of(params, mb)
        loss.backward()
        sums = {k: v + metrics[k].detach() for k, v in sums.items()}
    scale = 1.0 / accum_steps
    grads = {n: p.grad * scale for n, p in params.items()}
    for p in params.values():
        p.grad = None
    updates, opt_state = optimizer.update(grads, state.opt_state, params)
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n])
    return (TrainState(state.step + 1, params, opt_state),
            {k: v * scale for k, v in sums.items()})


def make_train_step(config: MIDIModelConfig, optimizer: Optimizer, accum_steps: int = 1,
                    compute_dtype=torch.bfloat16, remat: Union[bool, str] = False,
                    token_chunk: Optional[int] = None):
    """``step(state, batch [accum_steps, B, L, T]) -> (state, metrics)``:
    the gradients of the microbatches summed, times ``1 / accum_steps``,
    then one optimizer update; metrics are the microbatches' means.
    ``remat``: False, True / "full", "dots" or "dots_all"
    (``models.llama.remat_policy``)."""

    def loss_of(params, mb):
        return loss_fn(params, config, mb, compute_dtype, remat=remat, token_chunk=token_chunk)

    def train_step(state: TrainState, batch):
        return _accumulated_step(state, batch, accum_steps, optimizer, loss_of)

    return train_step


def make_lora_train_step(config: MIDIModelConfig, optimizer: Optimizer,
                         lora_alpha: float = 128.0, accum_steps: int = 1,
                         compute_dtype=torch.bfloat16, remat: Union[bool, str] = False,
                         token_chunk: Optional[int] = None):
    """The LoRA fine-tune step, ``step(state, base_params, batch) -> (state,
    metrics)`` (the JAX trainer's ``make_lora_train_step``).  The adapters
    (``models.lora``) are the only leaves of ``state.params``, so the only
    ones the optimizer updates; the frozen base weights are a separate
    argument that requires no gradient and is never written.  Each
    microbatch differentiates ``loss_fn`` through ``apply_lora`` (W +
    (α/r)·B@A), so gradients reach only the (A, B) factors — through the
    attention kernels' autograd function on the card."""
    from ..models.lora import apply_lora

    def train_step(state: TrainState, base_params: Params, batch):
        if any(p.requires_grad for p in base_params.values()):
            raise ValueError("the base weights of a LoRA step must not require grad")

        def loss_of(lora, mb):
            return loss_fn(apply_lora(base_params, lora, alpha=lora_alpha), config, mb,
                           compute_dtype, remat=remat, token_chunk=token_chunk)

        return _accumulated_step(state, batch, accum_steps, optimizer, loss_of)

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
def eval_step(params: Params, config: MIDIModelConfig, batch, token_chunk: int = 256) -> dict:
    """Validation loss and masked accuracy (bf16 compute, as the JAX
    package's ``eval_step``), the token net in chunks of ``token_chunk``."""
    _, metrics = loss_fn(params, config, batch, token_chunk=token_chunk)
    return metrics
