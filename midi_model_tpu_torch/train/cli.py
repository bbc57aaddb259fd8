"""Training CLI — the JAX package's ``train/cli.py`` for the port.

    python -m midi_model_tpu_torch.train.cli --data /path/to/midis --config tv2o-medium

The same flags as ``midi_model_tpu/train/cli.py``, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions, as the tests
do).  ``--task lora --ckpt W`` fine-tunes LoRA adapters (``--lora-r``,
``--lora-alpha``) on the frozen weights W and exports them in peft's layout
at each new best validation loss.  ``--remat`` / ``--remat full``
recomputes each layer whole in the backward; ``--remat dots`` saves the
layers' projection products and ``dots_all`` also their attention outputs
(``models.llama.REMAT_SAVES``).

A ``(data, model)`` mesh (``--dp``, ``--tp``; ``train.trainer``): one
process a rank, each holding its shard of the state.

- ``--multihost``: the ranks are this process and its peers, started by
  ``torchrun`` (``init_process_group("env://")`` from its variables; each
  process on its ``LOCAL_RANK``'s card); ``--dp 0`` is world // tp.
- ``--dp``/``--tp`` above 1 without ``--multihost``: the CLI spawns dp × tp
  local ranks (``parallel.spawn``), over NCCL where the host has a card a
  rank, over gloo otherwise (NCCL refuses two ranks on one card; gloo
  all-reduces CUDA tensors through the host).  ``--dp 0`` is 1 here.

``--batch-size-train`` is the global batch: each data shard loads its
share of it from its own slice of the files, with its own loader seed.
Validation gives each data shard a disjoint stride of the validation
files and reports the global masked mean; checkpoints and exports are
written in the single-device layout by the first rank, so ``--resume``
works on any mesh shape and on one device.  Example pieces are generated
by the first rank on the gathered weights.

SIGTERM/SIGINT request a checkpoint at the next step boundary, then a clean
exit (on a mesh the ranks agree on it each step); ``--resume`` restarts
from the latest checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import random
import signal
import sys
import time
from typing import NamedTuple

import numpy as np

# a collective that waits longer fails (example pieces on the first rank
# hold the others at the next one)
SPAWN_COLLECTIVE_TIMEOUT_S = 1800.0


class RunSummary(NamedTuple):
    """What a run of spawned ranks returns: the first rank's final step and
    last logged metrics."""

    step: int
    metrics: dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train the hierarchical MIDI model")
    p.add_argument("--resume", type=str, default="", help="resume from checkpoint dir")
    p.add_argument("--ckpt", type=str, default="", help="warm-start weights (.safetensors/.ckpt)")
    p.add_argument("--config", type=str, default="tv2o-medium",
                   help="model config name or config.json path")
    p.add_argument("--task", type=str, default="train", choices=["train", "lora"])
    p.add_argument("--lora-r", type=int, default=64, help="LoRA rank")
    p.add_argument("--lora-alpha", type=float, default=128.0, help="LoRA alpha")

    p.add_argument("--data", type=str, default="data", help="dataset path")
    p.add_argument("--data-val-split", type=int, default=128)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--quality", action="store_true", default=False)

    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--warmup-step", type=int, default=100)
    p.add_argument("--max-step", type=int, default=1_000_000)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--sample-seq", action="store_true", default=False,
                   help="bound token-net memory (runs the token-net+CE pass "
                        "in recomputed chunks of 2048 event positions)")
    p.add_argument("--token-chunk", type=int, default=0,
                   help="explicit token-net CE chunk size (0 = auto)")
    p.add_argument("--gen-example-interval", type=int, default=1)
    p.add_argument("--batch-size-train", type=int, default=2)
    p.add_argument("--batch-size-val", type=int, default=2)
    p.add_argument("--batch-size-gen-example", type=int, default=8)
    p.add_argument("--workers-train", type=int, default=4)
    p.add_argument("--acc-grad", type=int, default=2)
    p.add_argument("--fp32", action="store_true", default=False,
                   help="fp32 compute (default bf16 compute, fp32 master)")
    p.add_argument("--remat", nargs="?", const="full", default="",
                   choices=["", "full", "dots", "dots_all"],
                   help="activation checkpointing: 'full' (bare --remat) recomputes "
                        "each layer in the backward; 'dots' saves its projection products, "
                        "'dots_all' also its attention output")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel size (0 = world // tp under --multihost, else 1)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="join the process group torchrun started (env://) as one rank")
    p.add_argument("--log-step", type=int, default=1)
    p.add_argument("--val-step", type=int, default=1600)
    p.add_argument("--out-dir", type=str, default="runs")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def _check_supported(args) -> None:
    if args.task == "lora" and not args.ckpt:
        raise ValueError("--ckpt must be set to train lora")


def main(argv=None):
    """Train.  In this process: returns the final
    :class:`~.trainer.TrainState` (with ``--task lora`` its params are the
    adapters; on a mesh, this rank's shards).  With spawned ranks: returns
    the first rank's :class:`RunSummary`."""
    args = parse_args(argv)
    _check_supported(args)
    import torch
    import torch.distributed as dist

    if args.multihost:
        return _train_multihost(args)
    if not dist.is_initialized() and (args.dp or 1) * args.tp > 1:
        return _spawn_ranks(list(argv) if argv is not None else sys.argv[1:], args)
    return _train(args)[0]


def _train_multihost(args):
    """One rank of a process group that ``torchrun`` described in the
    environment: NCCL on this process's ``LOCAL_RANK`` card, gloo on the
    CPU."""
    import torch
    import torch.distributed as dist

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    print(f"process {dist.get_rank()}/{dist.get_world_size()}")
    try:
        return _train(args, device)[0]
    finally:
        dist.destroy_process_group()


def _spawn_ranks(argv, args) -> RunSummary:
    """dp × tp local ranks running this CLI (``parallel.spawn``), NCCL
    where the host has a card a rank, gloo otherwise; the first rank's
    final step and metrics."""
    import torch

    from ..parallel.mesh import spawn

    world = (args.dp or 1) * args.tp
    cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
    backend = "nccl" if cards >= world else "gloo"
    print(f"spawning {world} ranks over {backend}")
    summary = os.path.join(args.out_dir, "final.json")
    if os.path.exists(summary):
        os.remove(summary)
    spawn(_rank_main, world, (argv, summary), backend=backend, timeout_s=None,
          init_timeout_s=SPAWN_COLLECTIVE_TIMEOUT_S, daemon=False, forward_signals=True)
    with open(summary) as f:
        final = json.load(f)
    return RunSummary(final["step"], final["metrics"])


def _rank_main(argv, summary: str) -> None:
    """A spawned rank: train, and on the first rank write the final step
    and metrics to ``summary``."""
    import torch.distributed as dist

    args = parse_args(argv)
    state, metrics = _train(args)
    if dist.get_rank() == 0:
        with open(summary, "w") as f:
            json.dump({"step": state.step, "metrics": metrics}, f)


def _train(args, device=None):
    """Train in this process (a mesh over the initialized process group, if
    any): (the final state, the last logged metrics)."""
    import torch
    import torch.distributed as dist

    from ..models.config import CONFIG_NAMES, MIDIModelConfig
    from ..models.llama import resolve_device
    from ..parallel.mesh import data_shard, make_mesh
    from .checkpoint import CheckpointManager
    from .data import DataLoader, MidiDataset, find_midi_files
    from .metrics import MetricsWriter
    from .sched import linear_warmup_decay
    from .sharding import apply_lora_sharded, gather_params, shard_params
    from .trainer import (eval_step, init_params, init_train_state, make_lora_train_step,
                          make_optimizer, make_train_step)

    mesh = None
    if dist.is_initialized():
        world = dist.get_world_size()
        mesh = make_mesh(args.dp or None, args.tp,
                         device=device if device is not None else
                         ("cpu" if torch.device(args.device).type == "cpu" else None))
        if mesh is None or mesh.dp * mesh.tp != world:
            raise ValueError(f"--dp {args.dp} x --tp {args.tp} must use all {world} ranks")
        device = mesh.device
    else:
        device = resolve_device(args.device)
    first = mesh is None or dist.get_rank() == 0
    dp = 1 if mesh is None else mesh.dp
    data_rank = 0 if mesh is None else mesh.data_rank
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    config = (MIDIModelConfig.from_name(args.config) if args.config in CONFIG_NAMES
              else MIDIModelConfig.from_json_file(args.config))
    tokenizer = config.tokenizer
    if args.batch_size_train % dp:
        raise ValueError(f"--batch-size-train={args.batch_size_train} (global) not "
                         f"divisible by dp={dp}")
    local_bs = args.batch_size_train // dp

    midi_files = find_midi_files(args.data)
    random.shuffle(midi_files)  # the same seed on every rank: the same order
    split = len(midi_files) - args.data_val_split
    # each data shard its disjoint slice of the training files; the
    # validation list is whole on every rank (run_validation strides it)
    train_files, val_files = data_shard(midi_files[:split], mesh), midi_files[split:]
    print(f"train: {len(train_files)} (this data shard)  val: {len(val_files)}  "
          f"device: {device}  mesh: data={dp} model={1 if mesh is None else mesh.tp}")

    # on a mesh the datasets draw from their own generators: the model
    # shards of a data shard must see the same rows whatever else each rank
    # does with the global one (the first rank's example pieces)
    ds_seed = None if mesh is None else args.seed + data_rank
    train_ds = MidiDataset(train_files, tokenizer, max_len=args.max_len, aug=True,
                           check_quality=args.quality, rand_start=True, seed=ds_seed)
    val_ds = MidiDataset(val_files, tokenizer, max_len=args.max_len, aug=False,
                         check_quality=args.quality, rand_start=False, seed=ds_seed)
    loader = iter(DataLoader(train_ds, local_bs * args.acc_grad, workers=args.workers_train,
                             seed=args.seed + data_rank))

    if args.ckpt:
        from ..interop import load_state_dict, params_from_state_dict

        model = params_from_state_dict(load_state_dict(args.ckpt), config, device=device)
        params = {n: p.detach() for n, p in model.named_parameters()}
        del model
    else:
        params = init_params(config, seed=args.seed, device=device)

    optimizer = make_optimizer(lr=args.lr, weight_decay=args.weight_decay,
                               warmup_steps=args.warmup_step, total_steps=args.max_step,
                               grad_clip=args.grad_clip)
    compute_dtype = torch.float32 if args.fp32 else torch.bfloat16
    token_chunk = args.token_chunk or (2048 if args.sample_seq else None)
    kw = dict(accum_steps=args.acc_grad, compute_dtype=compute_dtype, remat=args.remat,
              token_chunk=token_chunk, mesh=mesh)
    if args.task == "lora":
        # adapter-only fine-tune: the state holds only the (A, B) factors
        # (replicated on a mesh); the frozen base is the step's separate
        # argument (this rank's shards on a mesh)
        from ..models import lora as lora_mod

        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + 1)
        lora = lora_mod.init_lora(params, gen, rank=args.lora_r)
        print(f"lora adapters initialized (r={args.lora_r}, alpha={args.lora_alpha})")
        lora_step = make_lora_train_step(config, optimizer, lora_alpha=args.lora_alpha, **kw)
        base = shard_params(params, mesh)

        def step_fn(state, batch):
            return lora_step(state, base, batch)

        @torch.no_grad()
        def merged_params(state):
            return apply_lora_sharded(base, state.params, args.lora_alpha, mesh)

        state = init_train_state(lora, optimizer)
    else:
        step_fn = make_train_step(config, optimizer, **kw)

        def merged_params(state):
            return state.params

        state = init_train_state(shard_params(params, mesh), optimizer)
    del params

    mgr = CheckpointManager(os.path.join(args.out_dir, "checkpoints"), config, mesh=mesh)
    if args.resume:
        state = mgr.restore(state)
        print(f"resumed from step {state.step}")
    writer = MetricsWriter(os.path.join(args.out_dir, "logs")) if first else None
    schedule = linear_warmup_decay(args.lr, args.warmup_step, args.max_step)

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        print(f"signal {signum}: checkpointing and stopping")
        stop_requested["flag"] = True

    def stop_agreed() -> bool:
        """Whether any rank was asked to stop: the ranks stop together, or
        the others would wait in a collective for the one that left."""
        if mesh is None or mesh.host_group is None:
            return stop_requested["flag"]
        flag = torch.tensor([int(stop_requested["flag"])])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.host_group)
        return bool(flag.item())

    previous = {sig: signal.signal(sig, _request_stop) for sig in (signal.SIGTERM, signal.SIGINT)}
    best_val = float("inf")
    logged = {}
    tokens_per_batch = (args.batch_size_train * args.acc_grad * args.max_len
                        * tokenizer.max_token_seq)
    try:
        t0 = time.time()
        while state.step < args.max_step:
            batch = next(loader)
            batch = batch.reshape(args.acc_grad, local_bs, *batch.shape[1:])
            state, metrics = step_fn(state, batch)
            step = state.step
            if step % args.log_step == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                t0 = time.time()
                logged = {"train/loss": loss, "train/lr": schedule(step),
                          "train/tokens_per_sec": tokens_per_batch / max(dt, 1e-9)}
                if writer is not None:
                    writer.log(step, logged)
            if args.val_step and step % args.val_step == 0:
                eval_params = merged_params(state)
                val_metrics = run_validation(eval_step, eval_params, config, val_ds,
                                             args.batch_size_val, args.max_len, mesh=mesh)
                logged.update({f"val/{k}": v for k, v in val_metrics.items()})
                if writer is not None:
                    writer.log(step, {f"val/{k}": v for k, v in val_metrics.items()})
                mgr.save(step, state, metrics=val_metrics)  # every rank joins
                if val_metrics["loss"] < best_val:
                    best_val = val_metrics["loss"]
                    if args.task == "lora":
                        mgr.export_peft_adapter(state.params, rank=args.lora_r,
                                                alpha=args.lora_alpha)
                    else:
                        mgr.export_safetensors(state.params)
                if args.gen_example_interval > 0:
                    full = gather_params(eval_params, mesh)  # every rank joins
                    if first:
                        gen_examples(full, config, val_ds, args, step, device)
                    del full
                del eval_params
            if stop_agreed():
                mgr.save(step, state)
                print(f"checkpointed at step {step}; exiting on signal")
                break
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        loader.close()  # stops the loader's worker processes
        if writer is not None:
            writer.close()
    return state, logged


def run_validation(eval_step, params, config, val_ds, batch_size, max_len,
                   max_batches: int = 16, mesh=None) -> dict:
    """Mean loss and accuracy over up to ``max_batches`` validation batches.

    On a mesh with several data shards (the JAX package's multihost
    scheme): each round takes ``batch_size`` items a data shard, disjoint
    strides of the validation list, and ``eval_step`` over the data group
    gives the round's global masked mean, the same on every rank.  Where
    the list is shorter than one round, every data shard evaluates the same
    batches alone."""
    dp = 1 if mesh is None else mesh.dp
    if dp > 1 and len(val_ds) >= batch_size * dp:
        bg = batch_size * dp
        losses, accs = [], []
        for r in range(min(max_batches, len(val_ds) // bg)):
            base = r * bg + mesh.data_rank * batch_size
            items = [val_ds[base + j] for j in range(batch_size)]
            m = eval_step(params, config, val_ds.collate(items, pad_to=max_len), mesh=mesh)
            losses.append(float(m["loss"]))
            accs.append(float(m["acc"]))
        return {"loss": float(np.mean(losses)), "acc": float(np.mean(accs))}
    if mesh is not None:  # the data shards evaluate alike: no data-group sums
        mesh = dataclasses.replace(mesh, dp=1, data_rank=0, data_group=None)
    losses, accs = [], []
    idx = 0
    for _ in range(max_batches):
        items = []
        for _ in range(batch_size):
            if idx >= len(val_ds):
                break
            items.append(val_ds[idx])
            idx += 1
        if not items:
            break
        m = eval_step(params, config, val_ds.collate(items, pad_to=max_len), mesh=mesh)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    if not losses:
        return {"loss": float("nan"), "acc": float("nan")}
    return {"loss": float(np.mean(losses)), "acc": float(np.mean(accs))}


def gen_examples(params, config, val_ds, args, step, device):
    """Sample pieces at a checkpoint with the port's ``generate`` (f32
    weights: the split decode path) and write them as ``.mid`` files, with a
    piano-roll ``.png`` beside each where Pillow is installed: unprompted,
    then continuing a validation piece."""
    import torch

    from ..midi import score2midi
    from ..models.midinet import MIDINet
    from ..sampling import generate

    if args.gen_example_interval <= 0:
        return
    out_dir = os.path.join(args.out_dir, "sample", str(step))
    os.makedirs(out_dir, exist_ok=True)
    tokenizer = config.tokenizer
    model = MIDINet(config, dtype=torch.float32, device=device)
    model.load_state_dict({n: p.detach() for n, p in params.items()})
    png = importlib.util.find_spec("PIL") is not None

    def write(prefix, outs):
        for i, seq in enumerate(outs):
            score = tokenizer.detokenize([list(r) for r in seq])
            with open(os.path.join(out_dir, f"{prefix}_{i}.mid"), "wb") as f:
                f.write(score2midi(score))
            if png:
                tokenizer.midi2img(score).save(os.path.join(out_dir, f"{prefix}_{i}.png"))

    write(0, generate(model, config, batch_size=args.batch_size_gen_example, max_len=256,
                      seed=step))
    if len(val_ds):
        prompt = np.asarray(val_ds.load_midi(random.randint(0, len(val_ds) - 1)),
                            dtype=np.int64)[:256]
        write(1, generate(model, config, prompt=prompt, batch_size=args.batch_size_gen_example,
                          max_len=512, seed=step))


if __name__ == "__main__":
    main()
