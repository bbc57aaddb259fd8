"""events_per_s: event rows delivered to clients in the window / the window."""

from bench_h100 import readings


def read(run):
    if not readings.is_serve(run):
        return None
    rows = sum(b[3] for r in run.records for b in r.blocks if run.in_window(b[0]))
    return rows / (run.t1 - run.t0)
