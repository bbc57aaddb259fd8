"""The one traffic generator: every mix is a data file under ``traffic/``
that this module reads.

Sizes are stratified: a mix of ``n`` draws takes the distribution's
quantiles at ``(i + 0.5) / n`` and the seed only orders them, so every seed
offers the same work in another order (and Poisson arrivals the same
inter-arrival gaps, reordered).  Token ids come from the seed.

Serving sessions mirror one click of the app's generate button:
``variations`` requests share one prompt and one ``submit_group``; knobs
follow the mix's rules by session index; a share of sessions start from
scratch (a prompt of one bos row).  Training rows are synthetic files that
obey the tokenizer's grammar, cropped or padded to the row length.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def quantiles(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` whole-number sizes of ``dist`` ({"dist": "uniform" |
    "log_uniform" | "fixed", "min", "max" or "value"}) at stratified
    quantiles, in the seed's order."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        v = np.full(n, float(dist["value"]))
    elif kind == "uniform":
        v = dist["min"] + u * (dist["max"] + 1 - dist["min"])
    elif kind == "log_uniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"] + 1)
        v = np.exp(lo + u * (hi - lo))
    else:
        raise ValueError(f"distribution {kind!r}")
    v = np.floor(v).astype(np.int64)
    if kind != "fixed":
        v = np.clip(v, dist["min"], dist["max"])
    return rng.permutation(v)


def arrivals(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """Due times of ``n`` Poisson arrivals at ``rate`` per second: the
    exponential gaps at stratified quantiles, in the seed's order."""
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u) / rate)
    return np.cumsum(gaps) - gaps[0]


@dataclass(eq=False)
class Session:
    index: int
    prompt: np.ndarray  # [p, T]
    gen_events: int
    knobs: Dict[str, float]
    disable_channels: Optional[List[int]]
    seed: int
    due: float = 0.0
    client: int = 0

    @property
    def greedy(self) -> bool:
        return int(self.knobs["top_k"]) == 1


def random_prompt(tok: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """A random ``[n, T]`` prompt, bos row first (random ids after it)."""
    t = tok["row"]
    rows = rng.integers(3, tok["vocab_size"], (n, t))
    rows[0] = tok["pad_id"]
    rows[0, 0] = tok["bos_id"]
    return rows


def session_knobs(mix: dict, i: int) -> tuple:
    knobs = dict(mix["knobs"]["default"])
    for rule in mix["knobs"].get("rules", ()):
        if i % rule["every"] == rule["at"]:
            knobs.update(rule["set"])
    ban = mix["knobs"].get("ban")
    bans = list(ban["disable_channels"]) if ban and i % ban["every"] == ban["at"] else None
    return knobs, bans


def sessions(mix: dict, tok: dict, seed: int, n: int) -> List[Session]:
    """The mix's first ``n`` sessions for ``seed`` (due times for an open
    loop, clients round robin for a closed one)."""
    rng = np.random.default_rng([seed, 1])
    scratch = rng.permutation(n) < round(n * mix.get("scratch_share", 0.0))
    plens = np.ones(n, np.int64)
    plens[~scratch] = quantiles(mix["prompt"], int((~scratch).sum()), rng)
    gens = quantiles(mix["generate"], n, rng)
    due = arrivals(mix["rate_sessions_per_s"], n, rng) if "rate_sessions_per_s" in mix else None
    seeds = rng.integers(0, 2 ** 31, n)
    out = []
    for i in range(n):
        knobs, bans = session_knobs(mix, i)
        prng = np.random.default_rng([seed, 2, i])
        out.append(Session(i, random_prompt(tok, prng, int(plens[i])), int(gens[i]), knobs,
                           bans, int(seeds[i]),
                           due=0.0 if due is None else float(due[i]),
                           client=i % mix.get("clients", 1)))
    return out


# ---- training rows ---------------------------------------------------------

@dataclass(eq=False)
class RowFeed:
    """Batches ``[accum, B, L, T]`` of synthetic files for ``seed``: each
    row a file of the mix's length (stratified over a pool of ``pool``
    files), its events drawn by the mix's event shares with parameters
    uniform in their ranges, bos first and eos last; a file longer than
    ``max_len`` is cropped at a random start, a shorter one padded."""

    mix: dict
    tok: dict
    seed: int
    pool: int = 4096
    _next: int = 0
    _lens: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self._lens = quantiles(self.mix["file_events"], self.pool, np.random.default_rng([self.seed, 3]))
        ev = self.tok["events"]
        names = list(ev)
        shares = np.asarray([self.mix["event_shares"].get(k, 0.0) for k in names], float)
        self._shares = shares / shares.sum()
        self._event_ids = np.arange(3, 3 + len(names))
        self._ranges = []  # per event: [(lo, hi)] per parameter
        base = 3 + len(names)
        starts = {}
        for p, size in self.tok["event_parameters"].items():
            starts[p] = (base, base + size)
            base += size
        for k in names:
            self._ranges.append([starts[p] for p in ev[k]])

    def row(self, i: int) -> np.ndarray:
        t = self.tok["row"]
        max_len = self.mix["max_len"]
        n = int(self._lens[i % self.pool])
        rng = np.random.default_rng([self.seed, 4, i])
        start = int(rng.integers(0, n - max_len + 1)) if n > max_len else 0
        length = min(n, max_len)
        rows = np.full((max_len, t), self.tok["pad_id"], np.int64)
        kinds = rng.choice(len(self._event_ids), size=length, p=self._shares)
        rows[:length, 0] = self._event_ids[kinds]
        u = rng.random((length, t - 1))
        for e, ranges in enumerate(self._ranges):
            sel = kinds == e
            for j, (lo, hi) in enumerate(ranges):
                rows[:length, j + 1] = np.where(sel, lo + (u[:, j] * (hi - lo)).astype(np.int64),
                                                rows[:length, j + 1])
        if start == 0:
            rows[0] = self.tok["pad_id"]
            rows[0, 0] = self.tok["bos_id"]
        if start + length == n:
            rows[length - 1] = self.tok["pad_id"]
            rows[length - 1, 0] = self.tok["eos_id"]
        return rows

    def batch(self) -> np.ndarray:
        a, b = self.mix["accum_steps"], self.mix["batch_size"]
        rows = [self.row(self._next + k) for k in range(a * b)]
        self._next += a * b
        return np.stack(rows).reshape(a, b, self.mix["max_len"], self.tok["row"])


def target_tokens(batch: np.ndarray, pad_id: int) -> int:
    """The non-pad target tokens of a batch ``[..., L, T]`` (rows 1 on)."""
    return int((batch[..., 1:, :] != pad_id).sum())
