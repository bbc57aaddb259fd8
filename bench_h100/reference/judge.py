"""The readings that decide ``correct``: what the program produced, held to
the plain reference.

Serving: every sampled request's prompt and served rows go through the
reference once (teacher-forced); at each served token the reading is the
gap by which the reference's logit of the served token lies below the
reference's best logit among the ids the grammar allows there.  The served
tokens are greedy, so a correct program serves the reference's best up to
rounding near a tie.  A served token the grammar does not allow is a
violation.

Training: the reference follows the program's first three steps on the
same weights and batches; the readings are each step's loss, each leaf's
norm of the first gradient as the optimizer gets it, and each leaf's norm
of the parameters' change after the three steps.

The reference is the ``MidiModel`` of the configuration's architecture
module (``spec.architecture``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import spec
from .grammar import Grammar
from .optim import AdamW
from .precision import full_f32


class ServedRequest:
    """One request as the client saw it: its prompt rows [p, T], the rows
    served [n, T] and its channel bans."""

    def __init__(self, prompt: np.ndarray, served: np.ndarray, disable_channels=None):
        self.prompt = np.asarray(prompt, np.int64)
        self.served = np.asarray(served, np.int64)
        self.disable_channels = list(disable_channels or [])


@torch.no_grad()
def served_logits(model, req: ServedRequest, device) -> torch.Tensor:
    """The model's logits [n, T, V] at every served token of ``req``."""
    n = len(req.served)
    seq = np.concatenate([req.prompt, req.served[:-1]])
    rows = torch.as_tensor(seq, device=device)[None]
    hidden = model.event_hidden(rows)[0, len(req.prompt) - 1:]
    served = torch.as_tensor(req.served, device=device)
    out = []
    for at in range(0, n, 512):
        out.append(model.token_logits(hidden[at:at + 512], served[at:at + 512, :-1]))
    return torch.cat(out)


def _gaps(ref_logits: torch.Tensor, chosen: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    """Per token: best allowed reference logit minus the chosen id's; inf
    where the chosen id is not allowed."""
    masked = ref_logits.masked_fill(~allow, float("-inf"))
    best = masked.amax(dim=-1)
    got = torch.gather(ref_logits, -1, chosen[..., None])[..., 0]
    ok = torch.gather(allow, -1, chosen[..., None])[..., 0]
    return torch.where(ok, best - got, torch.full_like(got, float("inf")))


def serve_readings(config: dict, state: Dict[str, torch.Tensor], requests: Iterable[ServedRequest],
                   device, control: bool = False) -> dict:
    """The widest gap over the served tokens of ``requests`` (the program's
    reading), or with ``control`` the widest gap of the token that the fp8
    reference puts first at each of the same positions."""
    grammar = Grammar(config["tokenizer"])
    model = spec.architecture(config).MidiModel
    with full_f32():
        ref = model(config, state, "f32")
        low = model(config, state, "fp8") if control else None
        widest, tokens, violations = 0.0, 0, 0
        for req in requests:
            if len(req.served) == 0:
                continue
            allow_np = grammar.allowed(req.served, True, req.disable_channels)
            allow = torch.as_tensor(allow_np, device=device)
            ref_logits = served_logits(ref, req, device)
            if low is None:
                chosen = torch.as_tensor(req.served, device=device)
                violations += grammar.violations(req.served, True, req.disable_channels)
            else:
                low_logits = served_logits(low, req, device)
                chosen = low_logits.masked_fill(~allow, float("-inf")).argmax(dim=-1)
            gaps = _gaps(ref_logits, chosen, allow)
            finite = gaps[torch.isfinite(gaps)]
            if len(finite):
                widest = max(widest, float(finite.max()))
            tokens += int(gaps.numel())
            del ref_logits
    return {"logit_gap": widest, "tokens": tokens, "grammar_violations": violations}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[List[str]] = None) -> tuple:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf: (gap, leaf)."""
    leaves = list(ref) if leaves is None else leaves
    median = float(np.median([ref[n] for n in ref]))
    worst, at = 0.0, None
    for n in leaves:
        g = abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
        if g >= worst:
            worst, at = g, n
    return worst, at


def moved_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's."""
    median = float(np.median(list(grad_norms.values())))
    return [n for n, g in grad_norms.items() if g >= share * median]


def train_reference(config: dict, state: Dict[str, torch.Tensor], batches: List[np.ndarray],
                    opt: dict, device, precision: str = "f32") -> dict:
    """Three (or ``len(batches)``) steps of the reference from ``state``
    (f32 masters), each batch ``[accum, B, L, T]``: losses, the first
    step's clipped gradient norms by leaf, the change norms by leaf."""
    with full_f32():
        params = {n: t.detach().float().clone() for n, t in state.items()}
        start = {n: t.clone() for n, t in params.items()}
        model = spec.architecture(config).MidiModel(config, params, precision)
        w = model.parameters()
        adam = AdamW(opt, w)
        losses, grad_norms = [], None
        for k, batch in enumerate(batches):
            grads = {n: torch.zeros_like(p) for n, p in w.items()}
            total = 0.0
            for mb in batch:
                for p in w.values():
                    p.requires_grad_(True)
                    p.grad = None
                loss = model.loss(torch.as_tensor(mb, device=device))
                loss.backward()
                total += float(loss.detach())
                for n, p in w.items():
                    grads[n] += p.grad
                    p.grad = None
                del loss
            for p in w.values():
                p.requires_grad_(False)
            grads = {n: g / len(batch) for n, g in grads.items()}
            clipped = adam.step(w, grads)
            if k == 0:
                grad_norms = {n: float(g.norm()) for n, g in clipped.items()}
            losses.append(total / len(batch))
            del grads, clipped
        change = {n: float((w[n] - start[n]).norm()) for n in w}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def train_numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared for a training cell, from the program's and the
    reference's readings (``train_reference``'s keys)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, grad_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    moved = moved_leaves(ref["grad_norms"])
    change, change_leaf = leaf_gap(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_rel": loss_rel, "grad_norm_gap": grad, "grad_norm_leaf": grad_leaf,
            "change_norm_gap": change, "change_norm_leaf": change_leaf,
            "leaves_compared": len(moved), "leaves": len(ref["change_norms"])}
