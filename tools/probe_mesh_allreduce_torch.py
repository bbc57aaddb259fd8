#!/usr/bin/env python3
"""Time the tensor-parallel all-reduce of ranks that share one card.

    python3 tools/probe_mesh_allreduce_torch.py [--rounds N]

Needs a CUDA card; imports torch and the port only.  Each mode spawns its
ranks (``parallel.spawn``, gloo, all on cuda:0) and runs N rounds of the
tp decode step's pattern at tv2o-large's width: a [32, 1024] x [1024, 2048]
bf16 product (a rank's MLP half), then an all-reduce of the [32, 1024]
bf16 result.  Printed per mode, as one JSON line: ms per round, and ms per
all-reduce with the card synchronized around it (a second pass).

- ``one_rank``: world size 1, the product alone (no all-reduce);
- ``gloo_cuda``: two ranks, ``all_reduce_sum`` on the CUDA tensor;
- ``gloo_host``: two ranks, the tensor copied to the host, all-reduced
  there and copied back (a yardstick only: the port all-reduces the CUDA
  tensor).

Then the card line of ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rank_rounds(mode: str, rounds: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from midi_model_tpu_torch.parallel import all_reduce_sum, make_mesh

    mesh = make_mesh(tp=dist.get_world_size())
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    x = torch.randn((32, 1024), generator=gen, device=mesh.device).to(torch.bfloat16)
    w = torch.randn((1024, 2048), generator=gen, device=mesh.device).to(torch.bfloat16)

    def reduce(y):
        if mode == "gloo_host":
            host = y.cpu()
            dist.all_reduce(host, group=mesh.model_group)
            y.copy_(host)
        elif mode == "gloo_cuda":
            all_reduce_sum(y, mesh.model_group)
        return y

    def one_round():
        y = (x @ w)[:, :1024].contiguous()
        return reduce(y) if mesh.tp > 1 else y

    for _ in range(20):
        one_round()
    torch.cuda.synchronize()
    dist.barrier(group=mesh.host_group)
    t0 = time.perf_counter()
    for _ in range(rounds):
        one_round()
    torch.cuda.synchronize()
    per_round = (time.perf_counter() - t0) * 1e3 / rounds
    synced = []
    for _ in range(min(rounds, 200)):
        y = (x @ w)[:, :1024].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mesh.tp > 1:
            reduce(y)
        torch.cuda.synchronize()
        synced.append(time.perf_counter() - t0)
    if dist.get_rank() == 0:
        synced.sort()
        Path(out).write_text(json.dumps({
            "mode": mode, "ranks": dist.get_world_size(), "rounds": rounds,
            "ms_per_round": per_round,
            "all_reduce_ms_synced_mean": sum(synced) * 1e3 / len(synced),
            "all_reduce_ms_synced_median": synced[len(synced) // 2] * 1e3}))


def run_mode(mode: str, rounds: int) -> dict:
    from midi_model_tpu_torch.parallel import spawn

    out = ROOT / "build" / "mesh_probe.json"
    out.unlink(missing_ok=True)
    world = 1 if mode == "one_rank" else 2
    t0 = time.perf_counter()
    spawn(rank_rounds, world, (mode, rounds, str(out)), timeout_s=300, init_timeout_s=120)
    result = json.loads(out.read_text())
    result["processes_s"] = time.perf_counter() - t0
    print(json.dumps(result), flush=True)
    return result


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=500)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_mesh_allreduce_torch.py: no CUDA device", file=sys.stderr)
        return 1
    for mode in ("one_rank", "gloo_cuda", "gloo_host"):
        run_mode(mode, args.rounds)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
