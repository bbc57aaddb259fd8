"""Serving cells: the app's deployment on the card, driven through
``BatcherService.submit_group`` as the app's generate button drives it.

Set-up builds the deployment (``ContinuousBatcher`` on the pools the mix's
deployment names, bf16 or int8 with bf16 scales, behind a
``BatcherService``, eos disabled so each request runs to its budget) on
weights made from the seed, warms each prefill bucket the mix can reach
with one session, then offers the mix's lead-in traffic to reach steady
occupancy.  The window is ``--seconds`` long:

- ``open``: sessions sent at their due times (Poisson at the mix's fixed
  rate), each on a thread of its own; a session due in the window is
  measured from its due time, so a late sender's wait counts;
- ``closed``: ``clients`` threads, each sending its next session when the
  last one's streams end.

After the window no new session starts; the sessions due in it are awaited
(at most ``DRAIN_S`` past the close, counted from the end of a traced
window's capture: stopping it holds the program's threads).  Then the peak
memory is read, the program freed, and the sampled greedy requests held to
the reference.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import common, traffic, weights
from .tracing import Tracer

DRAIN_S = 60.0
WARM_LENGTHS = (16, 64, 256, 1024, 4096)  # one warm session per bucket boundary in range


@dataclass(eq=False)
class Record:
    session: traffic.Session
    due: float = 0.0  # perf_counter seconds
    sent: Optional[float] = None
    submit_s: Optional[float] = None
    blocks: list = field(default_factory=list)  # (t, first row, rows, non-pad rows)
    rows: list = field(default_factory=list)  # [B, n, T] blocks as delivered
    done: Optional[float] = None
    error: Optional[str] = None


@dataclass
class ServeRun:
    """What a serving run leaves for the metric readers."""
    cell: object
    config: dict
    seconds: float
    t0: float = 0.0
    t1: float = 0.0
    setup_s: float = 0.0
    records: List[Record] = field(default_factory=list)
    admissions: list = field(default_factory=list)  # (t, bucket, [prompt rows])
    dispatches: list = field(default_factory=list)  # t of each chunk dispatched
    queued: list = field(default_factory=list)  # (t, requests waiting for a slot) at each dispatch
    chunk: int = 0
    pool: str = "bfloat16"  # the K/V pools' element: the config's dtype, or int8
    trace: object = None
    stuck: bool = False  # a session still open at the deadline

    def measured(self) -> List[Record]:
        return [r for r in self.records if self.t0 <= r.due < self.t1]

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t1


def instrument(batcher, run: ServeRun, tracer: Tracer):
    """Count the batcher's admissions and chunk dispatches, and open a
    benchmark range around each ``step`` and admission when tracing."""
    step, prefill, dispatch = batcher.step, batcher._prefill_group, batcher._dispatch

    def traced_step(*a, **k):
        with tracer.span("decode_step"):
            return step(*a, **k)

    def counted_prefill(bucket, part):
        run.admissions.append((time.perf_counter(), bucket,
                               [item[1].shape[0] for _slot, item in part]))
        with tracer.span("admit"):
            return prefill(bucket, part)

    def counted_dispatch(*a, **k):
        t = time.perf_counter()
        run.dispatches.append(t)
        run.queued.append((t, len(batcher.queue)))
        return dispatch(*a, **k)

    batcher.step, batcher._prefill_group, batcher._dispatch = (traced_step, counted_prefill,
                                                              counted_dispatch)


def build(config: dict, seed: int, dep: dict, device):
    import torch

    from midi_model_tpu_torch.models.config import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import MIDINet
    from midi_model_tpu_torch.serve.batcher import ContinuousBatcher

    dtype = getattr(torch, config["dtype"])
    cfg = MIDIModelConfig.from_dict(config)
    model = MIDINet(cfg, dtype=dtype, device=device)
    state = weights.make(config, seed, dtype, device)
    model.load_state_dict(state)
    del state
    batcher = ContinuousBatcher(model, cfg, n_slots=dep["slots"], max_seq=dep["max_seq"],
                                chunk=dep["chunk"], disable_eos=True,
                                kv_int8=dep.get("kv_int8", False))
    return model, batcher


def run_session(svc, rec: Record, variations: int, pad_id: int, tracer: Tracer):
    s = rec.session
    try:
        rec.sent = time.perf_counter()
        kw = dict(temp=s.knobs["temp"], top_p=s.knobs["top_p"], top_k=int(s.knobs["top_k"]),
                  seed=s.seed)
        if s.disable_channels:
            kw["disable_channels"] = s.disable_channels
        prompts = [s.prompt.astype(np.int32)] * variations
        with tracer.span("submit_group"):
            gen = svc.submit_group(prompts, s.gen_events, **kw)
        rec.submit_s = time.perf_counter() - rec.sent
        k = 0
        for block in gen:
            t = time.perf_counter()
            block = np.asarray(block)
            n = block.shape[1]
            rec.blocks.append((t, k, n, int((block[:, :, 0] != pad_id).sum())))
            rec.rows.append(block)
            k += n
        rec.done = time.perf_counter()
    except Exception as exc:  # a session that fails counts as failed, the run goes on
        rec.error = f"{type(exc).__name__}: {exc}"


def warm_sessions(mix: dict, tok: dict, seed: int, chunk: int) -> List[traffic.Session]:
    lo = 1 if mix.get("scratch_share", 0) > 0 else mix["prompt"]["min"]
    hi = mix["prompt"]["max"]
    lengths = sorted({lo, hi, *[b for b in WARM_LENGTHS if lo <= b <= hi]})
    rng = np.random.default_rng([seed, 6])
    knobs = dict(mix["knobs"]["default"])
    return [traffic.Session(-1 - i, traffic.random_prompt(tok, rng, n), chunk, knobs, None,
                            int(rng.integers(0, 2 ** 31))) for i, n in enumerate(lengths)]


def run(cell, seed: int, seconds: float, tracing: bool, device, started: float,
        fault=None) -> dict:
    """One run of a serving cell; returns the result and the compared numbers."""
    import torch

    from midi_model_tpu_torch.serve.batcher_service import BatcherService

    config, mix = cell.config, cell.traffic
    dep, tok = mix["deployment"], config["tokenizer"]
    variations = dep["variations"]
    srun = ServeRun(cell=cell, config=config, seconds=seconds, chunk=dep["chunk"],
                    pool="int8" if dep.get("kv_int8", False) else config["dtype"])
    model, batcher = build(config, seed, dep, device)
    print(f"decode path: {batcher.path} on {srun.pool} pools", file=sys.stderr)
    if fault is not None:
        fault(batcher)
    tracer = Tracer(tracing, all_threads=True)
    instrument(batcher, srun, tracer)
    svc = BatcherService(batcher)
    pool = ThreadPoolExecutor(max_workers=mix.get("threads", 48), thread_name_prefix="client")
    try:
        for s in warm_sessions(mix, tok, seed, dep["chunk"]):
            run_session(svc, Record(s), variations, tok["pad_id"], Tracer(False))
        srun.admissions.clear()
        srun.dispatches.clear()
        srun.queued.clear()
        lead = mix["lead_in_s"]
        if mix["loop"] == "open":
            n = int(math.ceil(mix["rate_sessions_per_s"] * (lead + seconds) * 1.25)) + 8
        else:
            n = mix["clients"] * mix["sessions_per_client"]
        plan = traffic.sessions(mix, tok, seed, n)
        start = time.perf_counter()
        srun.t0 = start + lead
        srun.t1 = srun.t0 + seconds
        srun.setup_s = srun.t0 - started
        if mix["loop"] == "open":
            drive_open(svc, pool, plan, srun, tracer, variations, tok["pad_id"], start)
        else:
            drive_closed(svc, pool, plan, srun, tracer, variations, tok["pad_id"],
                         mix["clients"])
    finally:
        svc.close()
        pool.shutdown(wait=not srun.stuck, cancel_futures=True)
    lateness = [r.sent - r.due for r in srun.measured() if r.sent is not None]
    if lateness:
        print(f"generator lateness: max {max(lateness) * 1e3:.3f} ms, p95 "
              f"{common.quantile(lateness, 0.95) * 1e3:.3f} ms over {len(lateness)} sessions",
              file=sys.stderr)
    print("distribution: " + json.dumps(distribution(srun)), file=sys.stderr)
    srun.trace = tracer.summary()
    device_line = common.device_info(device, cell.chips, srun.trace)
    del svc, batcher, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge(srun, seed, device)
    return srun, device_line, numbers


def drive_open(svc, pool, plan, srun, tracer, variations, pad_id, start):
    futures = []
    window_open = False
    for s in plan:
        due = start + s.due
        if due >= srun.t1:
            break
        if not window_open and due >= srun.t0:
            wait_until(srun.t0)
            tracer_cm = tracer.window()
            tracer_cm.__enter__()
            window_open = True
        wait_until(due)
        rec = Record(s, due=due)
        srun.records.append(rec)
        futures.append(pool.submit(run_session, svc, rec, variations, pad_id, tracer))
    if not window_open:
        wait_until(srun.t0)
        tracer_cm = tracer.window()
        tracer_cm.__enter__()
    wait_until(srun.t1)
    tracer_cm.__exit__(None, None, None)
    srun.stuck = not finish(futures, time.perf_counter() + DRAIN_S)


def drive_closed(svc, pool, plan, srun, tracer, variations, pad_id, clients):
    stop = threading.Event()

    def client(c):
        mine = [s for s in plan if s.client == c]
        for s in mine:
            if stop.is_set() or time.perf_counter() >= srun.t1:
                return
            rec = Record(s, due=time.perf_counter())
            srun.records.append(rec)
            run_session(svc, rec, variations, pad_id, tracer)

    futures = [pool.submit(client, c) for c in range(clients)]
    wait_until(srun.t0)
    with tracer.window():
        wait_until(srun.t1)
    stop.set()
    srun.stuck = not finish(futures, time.perf_counter() + DRAIN_S)


def wait_until(t: float):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05) if left > 0.002 else 0)


def finish(futures, deadline: float) -> bool:
    """Wait for the sessions until ``deadline``; False if one is still open
    then (it counts as incomplete and its thread is left behind)."""
    from concurrent.futures import TimeoutError as Timeout

    for f in futures:
        try:
            f.result(timeout=max(0.0, deadline - time.perf_counter()) + 1.0)
        except Timeout:
            return False
    return True


def judge(srun: ServeRun, seed: int, device) -> dict:
    """The numbers compared: the widest logit gap of the sampled greedy
    requests against the reference, the grammar violations of every row
    delivered, and the requests due in the window that never delivered
    their rows."""
    from .reference.grammar import Grammar
    from .reference.judge import serve_readings

    import torch

    config, mix = srun.config, srun.cell.traffic
    grammar = Grammar(config["tokenizer"])
    incomplete, violations = 0, 0
    measured = {id(r) for r in srun.measured()}
    for r in srun.records:
        served = np.concatenate(r.rows, axis=1) if r.rows else None
        if id(r) in measured and (r.error is not None or r.done is None or served is None
                                     or served.shape[1] != r.session.gen_events):
            incomplete += 1
        if served is not None:
            for v in served:
                violations += grammar.violations(v, True, r.session.disable_channels)
    requests = sample_requests(srun, seed)
    state = weights.make(config, seed, getattr(torch, config["dtype"]), device)
    readings = serve_readings(config, state, requests, device)
    del state
    return {"logit_gap": readings["logit_gap"] if requests else float("inf"),
            "grammar_violations": violations, "incomplete_requests": incomplete,
            "compared_tokens": readings["tokens"], "compared_requests": len(requests)}


def sample_requests(srun: ServeRun, seed: int) -> list:
    """The requests held to the reference, drawn from the seed: the greedy
    sessions that finished, the longest first, one variation of each."""
    from .reference.judge import ServedRequest

    done = [r for r in srun.records if r.session.greedy and r.done is not None and r.rows
            and r.error is None]
    rng = np.random.default_rng([seed, 7])
    k = srun.cell.traffic["check"]["sample_requests"]
    picked = []
    if done:
        longest = max(done, key=lambda r: len(r.session.prompt) + r.session.gen_events)
        rest = [r for r in done if r is not longest]
        picked = [longest] + [rest[i] for i in rng.permutation(len(rest))[:k - 1]]
    requests = []
    for r in picked:
        served = np.concatenate(r.rows, axis=1)
        v = int(rng.integers(served.shape[0]))
        requests.append(ServedRequest(r.session.prompt, served[v], r.session.disable_channels))
    return requests


def distribution(srun: ServeRun) -> dict:
    """Quantiles of the window's waits and gaps, for the record on stderr."""
    waits, gaps, submits = [], [], []
    for r in srun.measured():
        if r.blocks:
            waits.append(r.blocks[0][0] - r.due)
        times = [b[0] for b in r.blocks]
        gaps += [b - a for a, b in zip(times, times[1:])]
        if r.submit_s is not None:
            submits.append(r.submit_s)
    qs = (0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99)
    out = {"sessions": len(waits), "gaps": len(gaps),
           "queued_max": max((q for _, q in srun.queued), default=0)}
    for name, v in (("ttfc_ms", waits), ("gap_ms", gaps), ("submit_ms", submits)):
        out[name] = {f"p{round(q * 100)}": common.quantile(v, q) * 1e3 for q in qs} if v else {}
        out[name]["mean"] = 1e3 * sum(v) / len(v) if v else None
    return out
