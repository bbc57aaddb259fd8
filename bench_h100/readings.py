"""Quantities the metric readers share, from a run's records and trace."""

from __future__ import annotations

from typing import List

from . import work

PEAK = work.PEAK_FLOPS["bfloat16"]


def is_serve(run) -> bool:
    return hasattr(run, "records")


def is_train(run) -> bool:
    return hasattr(run, "steps")


def decoded_contexts(run) -> List[int]:
    """For every event row delivered in the window, the rows its slot held
    before its event step (prompt plus the rows before it)."""
    pad = run.config["tokenizer"]["pad_id"]
    out = []
    for r in run.records:
        p = len(r.session.prompt)
        for (t, k0, n, _), block in zip(r.blocks, r.rows):
            if not run.in_window(t):
                continue
            live = block[:, :, 0] != pad  # [B, n]
            for j in range(n):
                out.extend([p + k0 + j] * int(live[:, j].sum()))
    return out


def decode_flops(run) -> float:
    return sum(work.event_step_flops(run.config, c) for c in decoded_contexts(run))


def decode_bound_s(run) -> float:
    """A floor on the device time of the window's decoding: the weights read
    once per event step dispatched (chunks x chunk length), every delivered
    row's cache read and appended on the run's pools (``run.pool``,
    bfloat16 where the run names none), against the delivered rows'
    operations.  Overshoot rows that the host discards are left out."""
    contexts = decoded_contexts(run)
    if not contexts:
        return 0.0
    pool = getattr(run, "pool", "bfloat16")
    steps = sum(1 for t in run.dispatches if run.in_window(t)) * run.chunk
    n_bytes = steps * work.weight_bytes(run.config) + sum(
        work.cache_bytes(run.config, c, pool) for c in contexts)
    flops = sum(work.event_step_flops(run.config, c) for c in contexts)
    return max(n_bytes / work.HBM_BYTES_PER_S, flops / PEAK)


def admissions_in_window(run):
    return [(t, bucket, lens) for t, bucket, lens in run.admissions if run.in_window(t)]


def prefill_flops(run) -> float:
    return sum(work.prefill_flops(run.config, n) for _, _, lens in admissions_in_window(run)
               for n in lens)


def share(num: float, den: float):
    """A share in %, or None where there is nothing to read."""
    if not num or not den or den <= 0:
        return None
    return 100.0 * num / den
