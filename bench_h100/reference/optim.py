"""The optimizer that the training configuration states, written out: the
trainer's AdamW chain in optax's order — global-norm clipping, Adam (bias
corrected, eps outside the square root), decoupled weight decay on every
leaf but the two final norms, and the learning rate of a linear warmup and
decay at the update count before the update."""

from __future__ import annotations

from typing import Dict

import torch


def learning_rate(opt: dict, count: int) -> float:
    warm = max(1, opt["warmup_steps"])
    if count < opt["warmup_steps"]:
        return opt["lr"] * count / warm
    return opt["lr"] * max(0.0, (opt["total_steps"] - count)
                           / max(1, opt["total_steps"] - opt["warmup_steps"]))


class AdamW:
    def __init__(self, opt: dict, params: Dict[str, torch.Tensor]):
        self.opt = opt
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        no_decay = set(opt.get("no_decay", ()))
        self.decays = {n: n not in no_decay for n in params}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the clipped gradients."""
        o = self.opt
        b1, b2, eps = o["b1"], o["b2"], o["eps"]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        factor = torch.clamp(o["grad_clip"] / norm, max=1.0)
        lr = learning_rate(o, self.count)
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        clipped = {}
        for n, p in params.items():
            g = grads[n] * factor
            clipped[n] = g
            self.mu[n].mul_(b1).add_((1 - b1) * g)
            self.nu[n].mul_(b2).add_((1 - b2) * g * g)
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + eps)
            if self.decays[n]:
                u = u + o["weight_decay"] * p
            p.add_(-lr * u)
        return clipped
