"""ttfc_p90_ms: the 90th percentile, over the sessions due in the window, of
due time -> the session's first block of rows at the client.  A session
that never delivered counts with its wait until the run gave up on it."""

from bench_h100 import common, readings
from bench_h100.serve_cell import DRAIN_S


def read(run):
    if not readings.is_serve(run):
        return None
    waits = []
    for r in run.measured():
        first = r.blocks[0][0] if r.blocks else run.t1 + DRAIN_S
        waits.append(first - r.due)
    v = common.quantile(waits, 0.90)
    return None if v is None else v * 1e3
