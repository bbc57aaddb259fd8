#!/usr/bin/env python3
"""Find an open-loop serving cell's knee: the cell's run at each of a list
of session rates (the traffic file's other parameters unchanged), one
process, on the card.

    python3 bench_h100/sweep.py --workload <name> --rates 1,1.5,2 --seconds 30 --seed <n>

For each rate one JSON line: time to first chunk (p50, p95) and chunk gap
(p95), delivered events/s, the generator's lateness, the median time to
first chunk of the window's first and last thirds and the requests waiting
for a slot at the window's end (a backlog that grows shows in both).  The
knee is the highest rate whose last third does not wait longer than its
first and whose queue does not grow; the cell's rate is 4/5 of it.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402


def thirds(run):
    rows = sorted((r.due, (r.blocks[0][0] if r.blocks else float("inf")) - r.due)
                  for r in run.measured())
    n = len(rows) // 3
    if n == 0:
        return None, None
    return (statistics.median(w for _, w in rows[:n]), statistics.median(w for _, w in rows[-n:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from bench_h100 import common, serve_cell, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        cell = spec.find_cell(args.workload, ROOT)
        cell.traffic["rate_sessions_per_s"] = rate
        started = time.perf_counter()
        run, _, numbers = serve_cell.run(cell, args.seed + i, args.seconds, False,
                                         torch.device("cuda"), started)
        first, last = thirds(run)
        rows = sum(b[3] for r in run.records for b in r.blocks if run.in_window(b[0]))
        late = [r.sent - r.due for r in run.measured() if r.sent is not None]
        print(json.dumps({
            "rate": rate, "events_per_s": rows / args.seconds,
            "ttfc_median_first_third_ms": None if first is None else first * 1e3,
            "ttfc_median_last_third_ms": None if last is None else last * 1e3,
            "queued_at_end": run.queued[-1][1] if run.queued else None,
            "lateness_max_ms": max(late) * 1e3 if late else None,
            "logit_gap": numbers["logit_gap"], "incomplete": numbers["incomplete_requests"],
            **serve_cell.distribution(run), "card": common.card_line()}), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
