"""Training CLI on one device — the JAX package's ``train/cli.py`` for the port.

    python -m midi_model_tpu_torch.train.cli --data /path/to/midis --config tv2o-medium

The same flags as ``midi_model_tpu/train/cli.py``, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions, as the tests
do).  One device only: ``--dp``/``--tp`` above 1 and ``--multihost`` wait
for the multi-device port (ROADMAP).  ``--task lora --ckpt W`` fine-tunes
LoRA adapters (``--lora-r``, ``--lora-alpha``) on the frozen weights W and
exports them in peft's layout at each new best validation loss.
``--remat`` / ``--remat full`` recomputes each layer whole in the backward;
``--remat dots`` saves the layers' projection products and ``dots_all``
also their attention outputs (``models.llama.REMAT_SAVES``).

SIGTERM/SIGINT request a checkpoint at the next step boundary, then a clean
exit; ``--resume`` restarts from the latest checkpoint.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import random
import signal
import time

import numpy as np

_NOT_PORTED = {
    "dp": "data parallelism waits for the multi-device port (ROADMAP Queue A 10)",
    "tp": "tensor parallelism waits for the multi-device port (ROADMAP Queue A 10)",
    "multihost": "multi-host training waits for the multi-device port (ROADMAP Queue A 10)",
}


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
    p.add_argument("--dp", type=int, default=0, help="data-parallel size (1 device)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size (1 device)")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="multi-host training (not ported)")
    p.add_argument("--log-step", type=int, default=1)
    p.add_argument("--val-step", type=int, default=1600)
    p.add_argument("--out-dir", type=str, default="runs")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def _check_supported(args) -> None:
    if args.dp > 1:
        raise ValueError(_NOT_PORTED["dp"])
    if args.tp > 1:
        raise ValueError(_NOT_PORTED["tp"])
    if args.multihost:
        raise ValueError(_NOT_PORTED["multihost"])
    if args.task == "lora" and not args.ckpt:
        raise ValueError("--ckpt must be set to train lora")


def main(argv=None):
    """Train; returns the final :class:`~.trainer.TrainState` (with ``--task lora``
    its params are the adapters)."""
    args = parse_args(argv)
    _check_supported(args)
    import torch

    from ..models.config import CONFIG_NAMES, MIDIModelConfig
    from ..models.llama import resolve_device
    from .checkpoint import CheckpointManager
    from .data import DataLoader, MidiDataset, find_midi_files
    from .metrics import MetricsWriter
    from .sched import linear_warmup_decay
    from .trainer import (eval_step, init_params, init_train_state, make_lora_train_step,
                          make_optimizer, make_train_step)

    device = resolve_device(args.device)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    config = (MIDIModelConfig.from_name(args.config) if args.config in CONFIG_NAMES
              else MIDIModelConfig.from_json_file(args.config))
    tokenizer = config.tokenizer

    midi_files = find_midi_files(args.data)
    random.shuffle(midi_files)
    split = len(midi_files) - args.data_val_split
    train_files, val_files = midi_files[:split], midi_files[split:]
    print(f"train: {len(train_files)}  val: {len(val_files)}  device: {device}")

    train_ds = MidiDataset(train_files, tokenizer, max_len=args.max_len,
                           aug=True, check_quality=args.quality, rand_start=True)
    val_ds = MidiDataset(val_files, tokenizer, max_len=args.max_len,
                         aug=False, check_quality=args.quality, rand_start=False)
    loader = iter(DataLoader(train_ds, args.batch_size_train * args.acc_grad,
                             workers=args.workers_train, seed=args.seed))

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
              token_chunk=token_chunk)
    if args.task == "lora":
        # adapter-only fine-tune: the state holds only the (A, B) factors; the
        # frozen base is the step's separate argument
        from ..models import lora as lora_mod

        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + 1)
        lora = lora_mod.init_lora(params, gen, rank=args.lora_r)
        print(f"lora adapters initialized (r={args.lora_r}, alpha={args.lora_alpha})")
        lora_step = make_lora_train_step(config, optimizer, lora_alpha=args.lora_alpha, **kw)
        base = params

        def step_fn(state, batch):
            return lora_step(state, base, batch)

        @torch.no_grad()
        def merged_params(state):
            return lora_mod.merge_lora(base, state.params, alpha=args.lora_alpha)

        state = init_train_state(lora, optimizer)
    else:
        step_fn = make_train_step(config, optimizer, **kw)

        def merged_params(state):
            return state.params

        state = init_train_state(params, optimizer)
    del params

    mgr = CheckpointManager(os.path.join(args.out_dir, "checkpoints"), config)
    if args.resume:
        state = mgr.restore(state)
        print(f"resumed from step {state.step}")
    writer = MetricsWriter(os.path.join(args.out_dir, "logs"))
    schedule = linear_warmup_decay(args.lr, args.warmup_step, args.max_step)

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        print(f"signal {signum}: checkpointing and stopping")
        stop_requested["flag"] = True

    previous = {sig: signal.signal(sig, _request_stop) for sig in (signal.SIGTERM, signal.SIGINT)}
    best_val = float("inf")
    tokens_per_batch = (args.batch_size_train * args.acc_grad * args.max_len
                        * tokenizer.max_token_seq)
    try:
        t0 = time.time()
        while state.step < args.max_step:
            batch = next(loader)
            batch = batch.reshape(args.acc_grad, args.batch_size_train, *batch.shape[1:])
            state, metrics = step_fn(state, batch)
            step = state.step
            if step % args.log_step == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                t0 = time.time()
                writer.log(step, {"train/loss": loss, "train/lr": schedule(step),
                                  "train/tokens_per_sec": tokens_per_batch / max(dt, 1e-9)})
            if args.val_step and step % args.val_step == 0:
                eval_params = merged_params(state)
                val_metrics = run_validation(eval_step, eval_params, config, val_ds,
                                             args.batch_size_val, args.max_len)
                writer.log(step, {f"val/{k}": v for k, v in val_metrics.items()})
                mgr.save(step, state, metrics=val_metrics)
                if val_metrics["loss"] < best_val:
                    best_val = val_metrics["loss"]
                    if args.task == "lora":
                        mgr.export_peft_adapter(state.params, rank=args.lora_r,
                                                alpha=args.lora_alpha)
                    else:
                        mgr.export_safetensors(state.params)
                gen_examples(eval_params, config, val_ds, args, step, device)
                del eval_params
            if stop_requested["flag"]:
                mgr.save(step, state)
                print(f"checkpointed at step {step}; exiting on signal")
                break
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        loader.close()  # stops the loader's worker processes
        writer.close()
    return state


def run_validation(eval_step, params, config, val_ds, batch_size, max_len,
                   max_batches: int = 16) -> dict:
    """Mean loss and accuracy over up to ``max_batches`` validation batches."""
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
        m = eval_step(params, config, val_ds.collate(items, pad_to=max_len))
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
