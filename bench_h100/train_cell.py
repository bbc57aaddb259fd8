"""The training cell: the trainer's step (``train.trainer.make_train_step``)
at the CLI's defaults on weights made from the seed.

Set-up builds one training state and one step, and drives them through the
first ``check_steps`` steps with the window's own feed (rows assembled on
the host, all different); it keeps each step's loss, the first gradient as
the optimizer got it (from the first moment after one step: ``mu / (1 -
b1)``) and, after the last, each leaf's change from the start.  The window
then goes on with the same state and step: every step assembles its batch
on the host, runs, and reads its loss.  The rate is the non-pad target
tokens of the steps completed over the time from the window's start to the
last step's end.  After the window the state is freed and the reference
follows the first steps on the same weights and batches.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import common, traffic, weights, work
from .tracing import Tracer


@dataclass
class TrainRun:
    cell: object
    config: dict
    seconds: float
    t0: float = 0.0
    t1: float = 0.0
    setup_s: float = 0.0
    # (t end, non-pad target tokens, loss, the forward's model operations)
    steps: List[tuple] = field(default_factory=list)
    trace: object = None


def build(config: dict, mix: dict, seed: int, device):
    """(step, state, masters): the trainer's step at the mix's settings and
    its state on f32 masters made from the seed (``masters`` stays apart:
    the state holds copies)."""
    import torch

    from midi_model_tpu_torch.models.config import MIDIModelConfig
    from midi_model_tpu_torch.train import trainer as tr

    o = mix["optimizer"]
    opt = tr.Optimizer(o["lr"], o["weight_decay"], o["warmup_steps"], o["total_steps"],
                       o["grad_clip"], b1=o["b1"], b2=o["b2"], eps=o["eps"])
    step = tr.make_train_step(MIDIModelConfig.from_dict(config), opt,
                              accum_steps=mix["accum_steps"],
                              compute_dtype=getattr(torch, mix["compute_dtype"]))
    masters = weights.make(config, seed, torch.float32, device)
    return step, tr.init_train_state(masters, opt), masters


def first_moment_norms(state, b1: float) -> dict:
    """Each leaf's norm of the first gradient as the optimizer got it, from
    its first moment after one step (``mu = (1 - b1) g``)."""
    return {n: float(m.norm()) / (1 - b1) for n, m in state.opt_state.mu.items()}


def change_norms(state, masters) -> dict:
    return {n: float((state.params[n].detach() - masters[n]).norm()) for n in masters}


def run(cell, seed: int, seconds: float, tracing: bool, device, started: float,
        fault=None):
    import torch

    config, mix = cell.config, cell.traffic
    tok = config["tokenizer"]
    trun = TrainRun(cell=cell, config=config, seconds=seconds)
    step, state, masters = build(config, mix, seed, device)
    if fault is not None:
        step = fault(step)
    feed = traffic.RowFeed(mix, tok, seed)
    losses, grad_norms, check_batches = [], None, []
    for k in range(mix["check_steps"]):
        batch = feed.batch()
        check_batches.append(batch)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if k == 0:
            grad_norms = first_moment_norms(state, mix["optimizer"]["b1"])
    prog = {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change_norms(state, masters)}
    del masters

    tracer = Tracer(tracing)
    trun.t0 = time.perf_counter()
    trun.setup_s = trun.t0 - started
    deadline = trun.t0 + seconds
    with tracer.window():
        while True:
            with tracer.span("host_batch"):
                batch = feed.batch()
            with tracer.span("train_step"):
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])
            now = time.perf_counter()
            trun.steps.append((now, traffic.target_tokens(batch, tok["pad_id"]), loss,
                               work.train_forward_flops(config, batch)))
            if now >= deadline:
                break
    trun.t1 = trun.steps[-1][0]
    trun.trace = tracer.summary()
    device_line = common.device_info(device, cell.chips, trun.trace)
    del state, step, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge(trun, prog, check_batches, seed, device)
    return trun, device_line, numbers


def judge(trun: TrainRun, prog: dict, batches, seed: int, device) -> dict:
    import torch

    from .reference.judge import train_numbers, train_reference

    config, mix = trun.config, trun.cell.traffic
    state = weights.make(config, seed, torch.float32, device)
    ref = train_reference(config, state, batches, mix["optimizer"], device)
    del state
    numbers = train_numbers(prog, ref)
    numbers["nonfinite_losses"] = sum(1 for s in trun.steps if not np.isfinite(s[2]))
    return numbers
