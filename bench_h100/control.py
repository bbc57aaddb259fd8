#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, at the
cell's own size: the program's readings over many seeds, the control's (the
reference computed in float8 e4m3, the step below the bf16 the
configurations state, put in the program's place) and, for training, the
faults'.

    python3 bench_h100/control.py --workload <name> --seeds 1,2,3 [--seconds 10]

Serving: each seed runs the cell for ``--seconds`` at its own load; the
sampled greedy requests give the program's widest logit gap and, at the
same positions of the same prompts and tokens, the gap of the token the
fp8 reference puts first.  Training (no window): per seed the program's
first steps and the reference's, the fp8 reference in the program's place,
and the program with half of each microbatch's rows left out (the mean
taken over the rest).  A state left unchanged reads 1 on the change and
needs no run.  One JSON line per seed.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def serve_seed(cell, seed, seconds, device):
    import torch

    from bench_h100 import serve_cell, weights
    from bench_h100.reference.judge import serve_readings

    run, _, numbers = serve_cell.run(cell, seed, seconds, False, device, time.perf_counter())
    requests = serve_cell.sample_requests(run, seed)
    state = weights.make(cell.config, seed, getattr(torch, cell.config["dtype"]), device)
    control = serve_readings(cell.config, state, requests, device, control=True)
    return {"program": {k: numbers[k] for k in ("logit_gap", "compared_tokens")},
            "control_fp8": {k: control[k] for k in ("logit_gap", "tokens")}}


def train_seed(cell, seed, device):
    import torch

    from bench_h100 import train_cell, traffic, weights
    from bench_h100.reference.judge import train_numbers, train_reference

    config, mix = cell.config, cell.traffic
    o = mix["optimizer"]
    feed = traffic.RowFeed(mix, config["tokenizer"], seed)
    batches = [feed.batch() for _ in range(mix["check_steps"])]

    def program(half: bool):
        step, state, masters = train_cell.build(config, mix, seed, device)
        losses, grads = [], None
        for k, b in enumerate(batches):
            state, m = step(state, b[:, : b.shape[1] // 2] if half else b)
            losses.append(float(m["loss"]))
            if k == 0:
                grads = train_cell.first_moment_norms(state, o["b1"])
        change = train_cell.change_norms(state, masters)
        del state, masters, step
        torch.cuda.empty_cache()
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def reference(precision):
        state = weights.make(config, seed, torch.float32, device)
        out = train_reference(config, state, batches, o, device, precision)
        torch.cuda.empty_cache()
        return out

    ref = reference("f32")
    out = {"program": train_numbers(program(False), ref),
           "control_fp8": train_numbers(reference("fp8"), ref),
           "half_batch": train_numbers(program(True), ref)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)

    import torch

    from bench_h100 import common, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.find_cell(args.workload, ROOT)
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            out = serve_seed(cell, seed, args.seconds, device)
        else:
            out = train_seed(cell, seed, device)
        out.update(seed=seed, seconds=time.perf_counter() - t0, card=common.card_line())
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
