"""Megatron's collectives as autograd operators over a model group.

``parallel.mesh.all_reduce_sum`` sums in place and has no backward: right
for serving, which runs under ``no_grad``, wrong under autograd.  A
tensor-parallel layer under training puts these around its products:

- :func:`copy_to_model` before the column-parallel q/k/v and gate/up
  products (and the vocab-sharded ``lm_head``): identity forward, the
  gradient summed over the group backward (each shard's product sees only
  its part of the replicated input's gradient);
- :func:`reduce_from_model` after the row-parallel ``o_proj`` and
  ``down_proj``: the partial products summed forward, identity backward;
- :func:`gather_vocab` after the vocab-sharded ``lm_head``: the shards'
  logits concatenated along the last axis forward, this shard's slice of
  the gradient backward.

Without a group, or on a group of one, each is the identity.  Where
autograd records nothing (``no_grad``, or an input that needs no
gradient), :func:`reduce_from_model` sums in place as ``all_reduce_sum``
does, so the serving paths run the same collectives as before.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import all_reduce_sum


def _size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        at = dist.get_rank(ctx.group) * ctx.width
        return grad[..., at:at + ctx.width].contiguous(), None


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` (replicated over ``group``) as the input of a column-parallel
    product: the same values; its gradient is summed over ``group``."""
    if _size(group) == 1 or not _recorded(x):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """A row-parallel product's partial ``x`` summed over ``group`` (in
    ``x``'s dtype); the gradient passes through unchanged.  Unrecorded, it
    sums ``x`` in place (``all_reduce_sum``)."""
    if _size(group) == 1:
        return x
    if not _recorded(x):
        return all_reduce_sum(x, group)
    return _ReduceFromModel.apply(x, group)


def gather_vocab(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Each shard's ``x [..., V/n]`` (its slice of the vocab, in group-rank
    order) concatenated to ``[..., V]`` on every shard; the gradient of
    this shard's slice flows back to it."""
    if _size(group) == 1:
        return x
    return _GatherVocab.apply(x, group)
