#!/usr/bin/env python3
"""The CPU readings behind ``chip_smoke.TRAIN_MESH_TOLS``.

    python3 tools/train_mesh_cpu_reading_torch.py [--threads 8]

Phase 9 of ``chip_smoke.py`` holds step 0 of tv2o-medium trained at tp=2
and at dp=2 (gloo ranks sharing the card) to one device's step 0, in f32
and in bf16 compute, on the same weights and batch.  This script takes the
same comparison on the CPU: the same weights
(``chip_smoke.train_mesh_params``, made on the CPU from one seed), the same
microbatch (``train_mesh_batches``: 2 rows of 512 events from the golden
corpus), the same functions (``chip_smoke.step0_sample``,
``step0_errors``), with two gloo ranks on the CPU against one CPU process
(the kernels' plain versions).  It prints one JSON line per mesh and
dtype: the loss's relative difference and each sampled gradient's largest
difference relative to its leaf's largest value, the readings that
``chip_smoke.TRAIN_MESH_TOLS`` is built from.

It runs tv2o-medium at full width and depth on the CPU: three processes of
a few GB each, about two minutes on an 8-core host.
"""

import argparse
import importlib.util
import json
import pickle
import shutil
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
DTYPES = (torch.float32, torch.bfloat16)


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rank_reading(out_dir: str, batches, threads: int) -> None:
    """One rank: step 0 at tp=2, then at dp=2, each rank's share of the
    microbatch; rank 0 compares with the one-device reference."""
    from midi_model_tpu_torch.parallel import make_mesh
    from midi_model_tpu_torch.train.sharding import shard_params

    torch.set_num_threads(threads)
    cs = smoke()
    config, params = cs.train_mesh_params("cpu")
    step0, _ = batches
    ref = torch.load(Path(out_dir) / "ref.pt", weights_only=True)
    out = {}
    for what, dp, tp in (("tp=2", 1, 2), ("dp=2", 2, 1)):
        mesh = make_mesh(dp, tp, device="cpu")
        n = step0.shape[0] // dp
        rows = step0[mesh.data_rank * n:(mesh.data_rank + 1) * n]
        local = shard_params(params, mesh)
        for dtype in DTYPES:
            t0 = time.perf_counter()
            mine = cs.step0_sample(local, config, rows, dtype, mesh)
            out[what, str(dtype)] = {**cs.step0_errors(mine, ref[str(dtype)]),
                                     "seconds": time.perf_counter() - t0}
    if dist.get_rank() == 0:
        (Path(out_dir) / "reading.pkl").write_bytes(pickle.dumps(out))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", type=int, default=8, help="CPU threads in all")
    args = parser.parse_args()
    from midi_model_tpu_torch.parallel import spawn

    cs = smoke()
    config, work, batch_of = cs.training_corpus()
    batches = cs.train_mesh_batches(batch_of)
    out_dir = ROOT / "build" / "train_mesh_cpu_reading"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.set_num_threads(args.threads)
    config, params = cs.train_mesh_params("cpu")
    t0 = time.perf_counter()
    torch.save({str(dtype): cs.step0_sample(params, config, batches[0], dtype) for dtype in DTYPES},
               out_dir / "ref.pt")
    one_s = time.perf_counter() - t0
    del params
    spawn(rank_reading, 2, (str(out_dir), batches, max(1, args.threads // 2)),
          timeout_s=1800, init_timeout_s=900)
    reading = pickle.loads((out_dir / "reading.pkl").read_bytes())
    for (what, dtype), errs in reading.items():
        print(json.dumps({"mesh": what, "dtype": dtype, "device": "cpu",
                          "one_device_both_dtypes_s": one_s, **errs}), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
