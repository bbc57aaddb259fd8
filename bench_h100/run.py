#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``midi_model_tpu_torch``.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  The cell, its configuration, traffic, limits
and metrics come from ``BENCHMARK.json`` and the files under
``bench_h100/``.  With ``--trace 0`` the result line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checked``: each
number compared beside its limit, also the last lines of standard error).
Without a CUDA card, or with fewer than the cell asks for, it exits
non-zero and prints no result; so it does if the process has loaded
``jax``, ``jaxlib``, ``flax`` or ``midi_model_tpu`` by the end.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the import path: the
# harness's modules are imported as the package ``bench_h100``
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import os  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_h100 import common, spec

    cell = spec.find_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, check, run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  torch.device("cuda"), STARTED)
    bad = common.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    common.emit(result, check)
    if getattr(run, "stuck", False):
        os._exit(0)  # a session's thread never ended: do not wait for it at exit
    return 0


def run_cell(cell, seed: int, seconds: float, tracing: bool, device, started: float,
             fault=None):
    """(result without ``checked``, the compared numbers beside their
    limits, the run's records) of one run of ``cell`` on ``device``;
    ``fault`` plants a fault in the program (the harness's tests)."""
    from bench_h100 import common, serve_cell, spec, train_cell

    driver = {"serve": serve_cell, "train": train_cell}[cell.traffic["kind"]]
    run, device_line, numbers = driver.run(cell, seed, seconds, tracing, device, started,
                                           fault=fault)
    metrics = spec.read_metrics(cell.per_layer if tracing else cell.end_to_end, run)
    check = common.checked(numbers, cell.limits["limits"])
    if driver is serve_cell:
        attempted = len(run.measured())
        failed = int(numbers["incomplete_requests"])
    else:
        attempted = len(run.steps)
        failed = int(numbers["nonfinite_losses"])
    result = {"correct": common.passes(check), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_line}
    if tracing and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    print(f"card: {common.card_line()}; compared: " + ", ".join(
        f"{k}={v}" for k, v in numbers.items()), file=sys.stderr)
    return result, check, run


if __name__ == "__main__":
    sys.exit(main())
