"""Random weights in the layout of the configuration's architecture module
(``layout(config)``), made on the device from the seed in a few large
calls.  The same seed gives the same weights, so the reference can make
them again after the program's state is freed.

Each tensor has an init rule: ``("normal", std)``, ``("uniform", lo, hi)``
or ``("const", value)``.  A layout entry ``(name, shape)`` takes the
default rule: a matrix ``("normal", init_std)``, a vector ``("const",
1.0)`` (a norm scale); an entry ``(name, shape, rule)`` gives its own, as a
3-D tensor or a vector that is not a norm scale must.  The tensors of one
rule come from one draw in layout order, the rules in the order they first
appear: for the Llama family one N(0, init_std) draw for every matrix and
embedding, then the norm scales.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import spec

RULES = ("normal", "uniform", "const")


def rule(config: dict, entry: tuple) -> tuple:
    if len(entry) > 2:
        r = tuple(entry[2])
    elif len(entry[1]) == 2:
        r = ("normal", config["init_std"])
    elif len(entry[1]) == 1:
        r = ("const", 1.0)
    else:
        raise ValueError(f"{entry[0]}: a tensor of {len(entry[1])} dimensions needs its rule")
    if r[0] not in RULES:
        raise ValueError(f"{entry[0]}: init rule {r!r}: one of {RULES}")
    return r


def make(config: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    groups: Dict[tuple, list] = {}
    for entry in spec.architecture(config).layout(config):
        groups.setdefault(rule(config, entry), []).append((entry[0], tuple(entry[1])))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    out = {}
    for r, members in groups.items():
        if r[0] == "const":
            for n, s in members:
                out[n] = torch.full(s, float(r[1]), dtype=dtype, device=device)
            continue
        sizes = [torch.Size(s).numel() for _, s in members]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        if r[0] == "normal":
            flat.normal_(0.0, r[1], generator=gen)
        else:
            flat.uniform_(r[1], r[2], generator=gen)
        at = 0
        for (n, s), k in zip(members, sizes):
            out[n] = flat[at:at + k].view(s)
            at += k
    return out
