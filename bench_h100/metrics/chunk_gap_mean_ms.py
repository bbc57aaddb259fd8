"""chunk_gap_mean_ms: the mean of every gap between consecutive blocks of
rows reaching one session's client, over the sessions due in the window:
each stream's time from its first block to its last over its blocks."""

from bench_h100 import readings


def read(run):
    if not readings.is_serve(run):
        return None
    total, n = 0.0, 0
    for r in run.measured():
        if len(r.blocks) > 1:
            total += r.blocks[-1][0] - r.blocks[0][0]
            n += len(r.blocks) - 1
    return None if n == 0 else total / n * 1e3
