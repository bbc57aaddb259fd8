#!/usr/bin/env python3
"""Drive the PyTorch port (``midi_model_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--attention | --paged | --sampler | --step | --api | --app | --mesh]

With ``--attention``: phase 1 with ptxas' register and spill report, the
causal attention checks of phase 2, phase 6's step-0 checks and its timed
training loops (bf16 and f32 compute), and no result line.  With
``--paged``: phase 1 with the same report, phase 2's paged decode checks
(the cell and the streaming kernel) and their cold-cache timings, and no
result line.  ``--sampler``: phase 1 with the same report, phase 2's sampler
checks and timings and its token row check (the sample phase's µs at top_k
20 and 128), and no result line.  ``--step``: phase 1 with the same report,
phase 2's whole-step and event-loop checks (the whole step's phase clock
and its two timed cases, its int8 form, the aligned and ragged loops), the
token row check (with its case at granite's token-net width), the decode
kernels' launch shapes and the digests of every decode output (see
``decode_digests``), and no result line.  ``--api``: phase 1, one step of phase 6's
CLI to write a run directory, phase 7 on it, and no result line.  ``--app``:
phase 1, phase 8 on random bf16 weights, and no result line.  ``--mesh``:
phase 1, phase 9, and no result line.  ``--ssm``: phase 1, the Mamba-2
kernels of a hybrid event net (``check_ssm``: ``ssm_scan`` and ``ssm_step``
against their plain versions at granite-4.0-h-micro's widths, 32 slots,
prompts of 1, 3, 255, 256, 257 and 512 rows, with times), and no result
line.  Otherwise all phases, each printing
one JSON line; any failed check raises, so the script exits non-zero:

1. build   — compile the port's CUDA kernels from ``midi_model_tpu_torch/csrc``
             and count HGMMA / HMMA in the SASS of each attention kernel
             (the bf16 Dh-64 forward must hold HGMMA, every other Dh-64
             kernel, bf16 or f32, one of the two) and of each form of the
             decode kernels (token row, whole step, event loop: every bf16
             form must hold one of the two, no f32 form either);
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main paths' shapes, with times for both: sampler (ids
             identical on mixed rows and knobs, top_k 128, ties across
             warps, a keep decided by the summation order, k_cap 300; timed
             at five distributions x top_k 20 and 128 beside an empty
             kernel), paged
             decode, causal attention (bf16 at [4, 2048, 16, 64], the
             prefill shape [32, 1024, 16, 64], GQA at S = 2047 and the token
             net's [4094, 8, 4, 256]; f32 at [2, 2047, 16, 64], the prefill
             shape, the token net's shape, GQA at S = 2047 and two small
             cases; timed cases beside one
             ``scaled_dot_product_attention`` call, timed only), the
             streaming paged decode on bf16/f32/int8 pools and the cell
             kernel on int8 pools (ragged lengths, an inactive slot, a slot
             at capacity), the cell and streaming kernels timed side by side
             with a cold L2 (each call reads another layer's pages, a sweep
             of more than 100 MB) on bf16, f32 and int8 pools at the smoke's,
             uniform (64-2047 rows) and ragged lengths and with GQA, the
             token row (f32 rows identical; bf16 greedy
             rows identical up to near-ties; one bf16 launch with the phase
             clock: µs per phase kind and the barriers' wait; bf16 again at
             granite-4.0-h-micro's token net, D = W = 2048, where RMSNorm
             rows are wider than one staged segment), the fused
             event-net step (f32 within 1e-4; bf16 within 3e-2 after one
             layer, 0.125 after 12; rows outside the append bit-identical;
             one bf16 launch with the phase clock) and its int8-pool form
             (the same bounds, but f32 after one layer against the plain
             layer with the kernel's bf16 rounding of the v-scaled softmax
             weights at a rounding midpoint, and within 1e-2 after 12
             layers; appended int8 rows within one quantization step;
             inactive slots untouched), the causal attention backward
             (dq, dk, dv in f32 within 1e-4, bf16 within 2e-2, at the event
             and token nets' training shapes and GQA cases; each forward's
             LSE against the plain one; each training shape beside SDPA's
             backward alone, the bf16 event net's also beside its forward
             + backward, timed only), the
             8-event loop (f32
             rows identical and within 1e-4; bf16 rows against the
             per-event kernel pair) and the ragged event loop (f32 against
             its plain version; bf16 bit-identical to the per-event
             composition of the kernels, with eos mid-block, capacity and
             an inactive slot); then the cluster size and grid each decode
             kernel last launched with, and a digest of every decode
             wrapper's outputs, call by call (``decode_digests``: the same
             script run on two trees shows whether their kernels give the
             same bits);
3. oracle  — fp32 tv2o-medium weights rebuilt from
             ``tests/golden/reference_oracle.pkl``: logits within atol 2e-4 /
             rtol 2e-3 and greedy rows token-identical to the golden (the
             split path: fp32 weights);
4. slice   — bf16 tv2o-medium with random weights: ``generate`` at bs=32 on
             the default (fused) path — 8-event launches and a per-event
             tail —, on the split path, and with int8 pools on their default
             (the token row and the int8 whole step per event, no split
             kernel) and split paths, each with the launch counts of its
             kernels read from its own run; a timed prefill + 256-event
             ``decode_events`` run with eos disabled on five paths in turns
             (8-event launches, per-event fused launches, split; int8 pair,
             int8 split; the fused ones twice, the split ones once), with
             kernel launches per event; and
             ``generate`` from a random 1024-event prompt; every generated
             row must obey the grammar mask tables;
5. batcher — the continuous batcher at 32 slots, max_seq 2048, chunk 16,
             a queue of requests with mixed prompts, budgets, knobs and
             bans, run with eos enabled and again with eos disabled (every
             request to its budget): bf16 pools through the ragged event
             loop, then int8 pools through the per-event pair (token row,
             the whole step's int8 form; the default) and through the split
             scan (token row, streaming int8 kernel), each run with its
             launch counts, events/s, chunk count and latency and prefill
             time per admission group, then a full-occupancy window (eos
             disabled) timed and profiled; the int8 default must be the
             faster of its two paths; bf16 also resubmits a seeded request
             into another slot (identical rows);
6. train   — tv2o-medium training: step 0 through the attention kernels
             against plain attention (f32 and bf16 compute), the CLI (5
             steps, validation, checkpoint, export, examples, resume), and
             10 steps on a fixed batch in bf16 and then f32 compute (the
             ``--fp32`` path): a falling loss, step time, tokens/s, peak
             memory and the attention kernels' shares of a profiled step,
             by kernel;
7. api     — the user surface on phase 6's run directory (``phase_api``):
             ``MIDIModel.from_pretrained`` + ``generate`` at bs=32, the
             LoRA CLI (5 steps) and ``load_merge_lora`` + ``generate``, the
             LoRA step and the four remat policies timed with their peak
             memory, ``publish`` in bf16 and fp32 read back, and the
             ``torch.export`` programs' greedy rows against ``generate``;
8. app     — the serving app and the host data path (``phase_app``): the
             native extensions built with g++ (required) and held to the
             Python codec and scan on every golden, timed beside them;
             ``train.preprocess.main`` over ~2,000 golden copies with and
             without them (the same verdicts, files/s); the
             ``MidiGenerationService`` loaded as ``serve.app.main`` loads
             phase 6's checkpoint, batched (32 slots, chunk 16, context
             2048, batch 4): four concurrent sessions of 256 events
             (instruments, a MIDI prompt, allow_cc off, a continuation),
             with eos and again with the shared batch's eos disabled, rows
             checked against the grammar and the bans, ``.mid`` files read
             back, a seeded session identical alone and beside others,
             events/s and the seconds to each first chunk, the ragged event
             loop and the attention forward launched; one aligned session
             through the 8-event loop; ``examples/demo_torch.py`` on the
             card;
9. mesh    — multi-device serving and training (``phase_mesh``), every
             rank a process on a card.  On one card NCCL refuses two ranks, so the
             multi-rank runs go over gloo (CUDA tensors all-reduced through
             the host), and one world-size-1 run over NCCL; with several
             cards the ranks spread over them and the NCCL run takes two.
             Two ranks: rank 0 holds the paged cell and streaming kernels
             at a tp=2 shard's 8 heads and the causal attention forward at
             [32, 1024, 8, 64] against their plain versions; tp=2 at
             tv2o-large's full width and depth, greedy, on f32 weights with
             f32 and int8 pools and on bf16 (``generate_tp`` at bs=32,
             256 + 32 events, against one device's split path on the same
             token path; the tp batcher at 32 slots over 16 requests,
             against the single-device batcher): every
             differing row a near-tie, the hidden after 24 layers within
             TP_DEEP_TOLS;
             dp=2 at tv2o-medium (``generate_dp`` shards and the dp batcher
             equal to one device's).  Training on the same two ranks: rank 0
             holds the causal attention backward at the tp=2 shard's
             [2, 2047, 8, 64] and [4094, 8, 2, 256] (bf16, f32) to its plain
             version, timed beside SDPA's backward; tp=2 and dp=2 at
             tv2o-medium's full width and depth (``mesh_train_part``): step
             0's loss and sampled gradients in f32 and bf16 against one
             device's within TRAIN_MESH_TOLS, then 3 bf16 steps on a fixed
             batch with a falling loss.  Four ranks: the dp=2 x tp=2
             batcher at tv2o-medium's width and 4 layers, then the training
             CLI at ``--dp 2 --tp 2`` (3 steps, a validation, a checkpoint
             and an export in the single-device layout), then ``--resume``
             on one device for a 4th step.  NCCL: ``make_mesh()``, an
             all-reduce, ``generate_tp`` equal to ``generate`` (near-ties
             at tp=2).  Readings: launches per rank, events/s, all-reduces
             per event and per training step and their ms, ms a training
             step, peak memory per rank.  No reading is a scaling figure.

Then the kernel summary line (with each kernel's launches in phase 7 as
``api_launches``, in phase 8 as ``app_launches`` and in phase 9's mesh
runs, rank 0's, serving and training, as ``mesh_launches``), the card's
``nvidia-smi`` name and power limit,
and the result line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script fails before any result.
"""

from __future__ import annotations

import contextlib
import math
import json
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

LOGITS_TOL = dict(atol=2e-4, rtol=2e-3)  # oracle logits, as the JAX package's test
# bf16 whole step after all 12 layers: bf16 rounding flips from summation
# order compound with depth in any two correct implementations.  Recorded
# readings on an H100 (PERF.md section 6): kernel vs plain 0.094 (hidden), plain
# on the CPU vs plain on the card 0.078; the bound is 1.6x the latter.
BF16_DEEP_TOL = 0.125
# The whole step on int8 pools with f32 weights, after all 12 layers: the
# TPU kernel's int8 rule rounds every v-scaled softmax weight to bf16 even
# then, so a last-ulp difference of exp between two correct implementations
# now and then moves one weight by a bf16 step (2**-8), and the moves
# compound with depth.  Recorded reading on an H100 (PERF.md section 6):
# kernel vs plain 1.04e-3 (hidden); 1e-4 holds after one layer.
INT8_F32_DEEP_TOL = 1e-2
# the attention forwards' f32 log-sum-exp (values up to ~10) against the
# plain version's: f32 rounding of the scores, the row sum and its log only
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up.  A
    sleep kernel holds the stream while the host issues the calls (twice the
    host time of one call per call, at most 0.5 s), so the events time the
    card's work and not the host's pace: a wrapper that takes longer to issue
    than its kernels take to run would otherwise be timed at the former.
    ``fn`` may be a list of calls, issued in turn (call i is ``fn[i % n]``):
    calls that read different memory time a cold cache."""
    import torch

    with _untimed_digests_paused():
        return _time_ms(fn, iters)


def _time_ms(fn, iters: int) -> float:
    import torch

    calls = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    for call in calls:
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls[0]()
    torch.cuda.synchronize()
    hold_s = min(2 * (time.perf_counter() - t0) * iters, 0.5)
    torch.cuda._sleep(int(hold_s * 2e9))  # cycles: the H100's clock is at most 1.98 GHz
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# decode_digests: {wrapper: [digest of each call's outputs]} while recording
_DIGESTS = None
_DIGEST_PAUSED = [0]


@contextlib.contextmanager
def _untimed_digests_paused():
    _DIGEST_PAUSED[0] += 1
    try:
        yield
    finally:
        _DIGEST_PAUSED[0] -= 1


def _tensor_digest(out) -> str:
    """sha256 (16 hex digits) of the tensors in ``out`` (a tensor or nested
    tuples and lists; anything else is left out), their shapes, dtypes and
    bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().contiguous().cpu()
            h.update(f"{tuple(t.shape)} {t.dtype}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(x, (tuple, list)):
            for y in x:
                add(y)

    add(out)
    return h.hexdigest()[:16]


@contextlib.contextmanager
def decode_digests():
    """Record a digest of the outputs of every call of the decode wrappers
    (``token_loop.decode_token_row``, ``fused_step.fused_decode_step``,
    ``event_loop.decode_event_block`` and ``decode_event_block_ragged``) on
    the card, in call order, leaving out the calls ``time_ms`` times; at the
    end emit them with the shape each decode kernel last launched with
    (``_build.SHAPES``).  The checks draw their inputs from seeded
    generators, so this script run against two trees of the port gives the
    same digests where their kernels give the same bits."""
    global _DIGESTS
    import torch

    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.ops import event_loop as el
    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import token_loop as tl

    wrapped = [(tl, "decode_token_row"), (fs, "fused_decode_step"),
               (el, "decode_event_block"), (el, "decode_event_block_ragged")]
    saved = [getattr(mod, name) for mod, name in wrapped]
    _DIGESTS = {name: [] for _, name in wrapped}

    def recorded(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if not _DIGEST_PAUSED[0]:
                torch.cuda.synchronize()
                _DIGESTS[name].append(_tensor_digest(out))
            return out
        return call

    for (mod, name), fn in zip(wrapped, saved):
        setattr(mod, name, recorded(name, fn))
    try:
        yield
        shapes = {k: dict(zip(("cluster", "blocks"), v))
                  for k, v in sorted(getattr(_build, "SHAPES", {}).items())}
        emit({"phase": "decode_digests", "launch_shapes": shapes,
              "calls": {k: len(v) for k, v in _DIGESTS.items()}, "digests": _DIGESTS})
    finally:
        for (mod, name), fn in zip(wrapped, saved):
            setattr(mod, name, fn)
        _DIGESTS = None


def check_rows(rows, table, tokenizer, what: str) -> None:
    """Every row obeys the mask tables: step 0 in ``first``; after eos only
    pad; otherwise step i in ``steps[event, i]``."""
    import numpy as np

    rows = np.asarray(rows).reshape(-1, rows.shape[-1])
    first = rows[:, 0]
    require(table.first[first].all(), f"{what}: step-0 token outside the table")
    eos = first == tokenizer.eos_id
    require((rows[eos, 1:] == tokenizer.pad_id).all(), f"{what}: non-pad after eos")
    ev = rows[~eos]
    e_off = ev[:, 0] - table.first_event_id
    for i in range(1, rows.shape[1]):
        require(table.steps[e_off, i, ev[:, i]].all(),
                f"{what}: step {i} token outside the table")


# the attention kernels (csrc/causal_attention*.cu) by head dim: at 64 the
# bf16 forms (wgmma forward, mma.sync backward) and the f32 forms (3xTF32 on
# mma.sync); at 256 the packed-rows forms of both dtypes (CUDA cores)
ATTENTION_KERNELS = {"fwd_wgmma_kernel": 64, "dkdv_tc_kernel": 64, "dq_tc_kernel": 64,
                     "fwd_tf32_kernel": 64, "dkdv_tf32_kernel": 64, "dq_tf32_kernel": 64,
                     "fwd_rows256_kernel": 256, "dkdv_rows256_kernel": 256,
                     "dq_rows256_kernel": 256}


# the whole-step decode kernels (csrc/token_loop.cu, fused_step.cu,
# event_loop.cu): their bf16 forms run the products on tensor cores, their
# f32 forms on CUDA cores
DECODE_KERNELS = ("token_row_kernel", "fused_step_kernel", "event_loop_kernel")
# the mangled template arguments after "<kernel>I": weights, then (the whole
# step) pools
DECODE_FORMS = {"13__nv_bfloat16S": "bf16", "13__nv_bfloat16a": "bf16, int8 pools",
                "13__nv_bfloat16E": "bf16", "ff": "f32", "fa": "f32, int8 pools",
                "fE": "f32"}


def sass_tensor_ops(path: Path):
    """From ``cuobjdump -sass`` of the library: how many HGMMA (wgmma) and
    HMMA (mma.sync) instructions the SASS of each attention kernel (both
    dtypes' forms of a templated kernel summed) and of each form of the
    decode kernels holds."""
    import os
    import re

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found = {name: {"HGMMA": 0, "HMMA": 0} for name in ATTENTION_KERNELS}
    decode = {}
    current = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            current = next((found[n] for n in ATTENTION_KERNELS if n in fn), None)
            for n in DECODE_KERNELS:
                form = re.search(n + r"I(13__nv_bfloat16.|f.)", fn)
                if form:
                    current = decode.setdefault(f"{n} ({DECODE_FORMS[form.group(1)]})",
                                                {"HGMMA": 0, "HMMA": 0})
        elif current is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    current[op] += 1
    return found, decode


def phase_build(card: str, verbose: bool = False):
    from midi_model_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=verbose)
    _build.library()
    seconds = time.perf_counter() - t0
    ops, decode = sass_tensor_ops(path)
    require(ops["fwd_wgmma_kernel"]["HGMMA"],
            f"the bf16 Dh-64 attention forward runs no wgmma: {ops['fwd_wgmma_kernel']}")
    for name, dh in ATTENTION_KERNELS.items():
        require(dh != 64 or ops[name]["HGMMA"] or ops[name]["HMMA"],
                f"{name} (Dh 64) holds neither HGMMA nor HMMA")
    forms = {"token_row_kernel": ("bf16", "f32"), "event_loop_kernel": ("bf16", "f32"),
             "fused_step_kernel": ("bf16", "bf16, int8 pools", "f32", "f32, int8 pools")}
    for name, kinds in forms.items():
        for kind in kinds:
            got = decode.get(f"{name} ({kind})")
            require(got is not None, f"no SASS for {name} ({kind}): {sorted(decode)}")
            tensor = got["HGMMA"] + got["HMMA"]
            require(tensor > 0 if kind.startswith("bf16") else tensor == 0,
                    f"{name} ({kind}): {got} (bf16 forms on tensor cores, f32 forms not)")
    emit({"phase": "build", "seconds": seconds, "library": str(path.relative_to(ROOT)),
          "attention_sass": ops, "decode_sass_tensor_ops": decode, "card": card})


def phase_kernels(card: str) -> dict:
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = {}

    results["sampler"] = check_sampler(card, gen)
    worst = check_paged_cell(card, gen)
    results.update(check_attention(card, gen))
    worst.update(check_paged_stream(card, gen))
    with decode_digests():
        results["token_row"] = check_token_row(card, gen)
        results["fused_step"] = check_fused_step(card, gen)
        results["fused_step_int8"] = check_fused_step_int8(card, gen)
        results.update(check_attention_bwd(card, gen))
        results["event_loop"] = check_event_loop(card, gen)
        results["event_loop_ragged"] = check_event_loop_ragged(card, gen)
    results.update(paged_kernel_rows(time_paged_cell_vs_stream(card), worst))
    return results


def tree_flip_row(rng, v: int):
    """A row and top_p where the exclusive running mass at some rank r
    equals top_p summed rank by rank in f32 but exceeds it summed as a
    pairwise tree (as a warp or block reduction takes it): (row, top_p, r).
    The sampler must keep rank r."""
    import numpy as np

    def tree(x):
        x = np.asarray(x, np.float32)
        while len(x) > 1:
            x = np.concatenate([x, np.zeros(len(x) % 2, np.float32)])
            x = (x[0::2] + x[1::2]).astype(np.float32)
        return x[0] if len(x) else np.float32(0)

    for _ in range(2000):
        x = np.zeros(v, np.float32)
        x[rng.choice(v, 96, replace=False)] = (rng.random(96) * 0.02 + 1e-4).astype(np.float32)
        t = np.float32(0)
        for r, val in enumerate(np.sort(x[x > 0])[::-1]):
            if r >= 8 and tree(np.sort(x[x > 0])[::-1][:r]) > t:
                return x, t, r
            t = np.float32(t + val)
    raise RuntimeError("no row whose keep flips with the summation order")


def sampler_rows(kind: str, b: int, v: int, gen, masks=None):
    """[b, v] rows of one distribution besides the smoke's headline rows
    (softmax(3 z)): "flat" softmax(z / 2) (pitch- or velocity-like),
    "peaked" softmax(8 z), "confident" one id holding ~99.9% of the mass,
    "masked" softmax(3 z) times a token-grammar mask of a random event and
    step (mass < 1, as the sample phase hands it over)."""
    import torch

    z = torch.randn((b, v), generator=gen, device=gen.device)
    if kind == "confident":
        z[torch.arange(b), torch.randint(0, v, (b,), generator=gen, device=gen.device)] += 16.0
    scale = {"flat": 0.5, "peaked": 8.0, "confident": 1.0, "masked": 3.0}[kind]
    probs = torch.softmax(z * scale, dim=-1)
    if kind == "masked":
        e = torch.randint(0, masks.steps.shape[0], (b,), generator=gen, device=gen.device)
        j = torch.randint(1, masks.steps.shape[1], (b,), generator=gen, device=gen.device)
        allowed = masks.steps[e, j]
        # a step an event does not have allows nothing: fall back to step 1
        empty = ~allowed.any(dim=1)
        allowed[empty] = masks.steps[e[empty], 1]
        probs = probs * allowed
    return probs.contiguous()


def check_sampler(card: str, gen) -> dict:
    """The sampler kernel against its plain version at [32, 3406]: ids
    identical on peaked, flat, tied, masked and massless rows with per-row
    knobs (top_k 0 to 200 at k_cap 128, and every row at top_k 128), the
    n_iter-th value tied across every warp and pass, a row whose keep flips
    if the running mass is summed as a tree, k_cap 300 at top_k 260
    (windows past the first 128 ranks) and a 9000-id row (the compaction
    past 32 passes a thread).  Then timed at five distributions x
    top_k 20 and 128 (top_p 0.98), beside an empty kernel (the launch
    floor)."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.ops import sampler as sp
    from midi_model_tpu_torch.sampling import build_mask_table, mask_tensors
    from midi_model_tpu_torch.models import MIDIModelConfig

    dev = torch.device("cuda")
    b, v, k_cap = 32, 3406, 128
    # the mixed rows, their 16 draws and the headline rows come from `gen` as
    # they did before the cases below were added, so the checks after this
    # one see the generator in the same state; the added cases and timed rows
    # come from a generator of their own
    own = torch.Generator(device=dev)
    own.manual_seed(99)
    logits = torch.randn((b, v), generator=gen, device=dev)
    logits[0:8] *= 8.0  # peaked
    logits[8:16] = 0.0  # flat: every entry ties
    logits[16:24] = torch.round(logits[16:24])  # many ties
    probs = torch.softmax(logits, dim=-1)
    masked = torch.rand((8, v), generator=gen, device=dev) < 0.05
    probs[24:32] *= masked  # masked zeros, mass < 1
    probs[31] = 0.0  # no mass at all: index 0
    top_p = torch.tensor([0.98, 0.5, 1.0, 0.1] * 8, device=dev)
    top_k = torch.tensor([20, 1, 128, 5, 64, 200, 0, 3] * 4, dtype=torch.int32,
                         device=dev)
    top_k_128 = torch.full((b,), 128, dtype=torch.int32, device=dev)

    # the n_iter-th value shared by 150 entries of every warp and several passes
    rng = np.random.default_rng(7)
    tied = np.full((b, v), 1e-5, np.float32)
    tied[:, [3, 900, 2001]] = [0.3, 0.2, 0.1]
    for r in range(b):
        tied[r, rng.choice(np.setdiff1d(np.arange(v), [3, 900, 2001]), 150,
                           replace=False)] = 0.3 / 150
    tied = torch.as_tensor(tied, device=dev)
    flip, flip_p, flip_r = tree_flip_row(rng, v)
    flip = torch.as_tensor(np.stack([flip] * b), device=dev)
    cases = [("mixed", probs, top_p, top_k, k_cap), ("mixed_top_k_128", probs, top_p, top_k_128,
                                                      k_cap),
             ("tied_across_warps", tied, torch.ones(b, device=dev),
              torch.full((b,), 20, dtype=torch.int32, device=dev), k_cap),
             ("sum_order", flip, torch.full((b,), float(flip_p), device=dev), top_k_128, k_cap),
             ("windows_k_cap_300", probs, torch.ones(b, device=dev),
              torch.full((b,), 260, dtype=torch.int32, device=dev), 300),
             # past 32 passes a thread: the compaction without its pass mask
             ("wide_vocab_9000", torch.softmax(torch.randn((b, 9000), generator=own,
                                                           device=dev) * 2, -1),
              top_p, top_k_128, k_cap)]
    mismatches = {}
    for name, pr, tp, tk, kc in cases:
        bad = 0
        src = gen if name == "mixed" else own
        for i in range(16 if name == "mixed" else 8):
            g = -torch.log(torch.empty((b, kc), device=dev).exponential_(generator=src))
            if name == "mixed":
                g_main = g
            if name == "sum_order" and i == 0:
                g[:, flip_r] = 50.0  # the rank whose keep the summation order decides
            if name == "tied_across_warps" and i == 0:
                g[:, 3:20] = 0.0
                g[torch.arange(b), 3 + torch.arange(b, device=dev) % 17] = 50.0
            ids = sp.sample_top_p_k(pr, tp, tk, g)
            ref = sp.sample_top_p_k_reference(pr, tp, tk, g)
            torch.cuda.synchronize()
            bad += int((ids != ref).sum())
            if name == "sum_order" and i == 0:
                order = torch.argsort(-pr[0].cpu(), stable=True)
                require(bool((ids == int(order[flip_r])).all()),
                        "sampler: the rank kept only by the sequential running mass was not drawn")
        mismatches[name] = bad
    require(not any(mismatches.values()),
            f"sampler: ids differ from the plain version: {mismatches}")

    # timings: five distributions x top_k 20 and 128, top_p 0.98
    masks = mask_tensors(build_mask_table(MIDIModelConfig.from_name("tv2o-medium").tokenizer),
                         dev)
    top_p_main = torch.full((b,), 0.98, device=dev)
    main_probs = torch.softmax(torch.randn((b, v), generator=gen, device=dev) * 3, -1)
    timings = {}
    for kind in ("main", "flat", "peaked", "confident", "masked"):
        rows = main_probs if kind == "main" else sampler_rows(kind, b, v, own, masks)
        for k in (20, 128):
            tk = torch.full((b,), k, dtype=torch.int32, device=dev)
            timings[f"{kind}_top_k_{k}"] = time_ms(
                lambda: sp.sample_top_p_k(rows, top_p_main, tk, g_main), 200)
    floor = time_ms(lambda: torch.cuda._sleep(0), 200)
    top_k_main = torch.full((b,), 20, dtype=torch.int32, device=dev)
    n_iter = int(torch.clamp(top_k_main, max=k_cap).sum())
    result = {
        "max_abs_err": float(sum(mismatches.values())),
        "ms": timings["main_top_k_20"],
        "plain_ms": time_ms(lambda: sp.sample_top_p_k_reference(
            main_probs, top_p_main, top_k_main, g_main), 5),
        "library_ms": None,
        # probs once, each row's n_iter noise values, top_p, top_k and the id;
        # one compare an entry and a log and an add a rank
        **bound(b * v * 4 + n_iter * 4 + b * 12, b * v + 2 * n_iter, "f32"),
    }
    emit({"phase": "kernel", "name": "sampler", "shape": [b, v], "ids_identical": True,
          "mismatches": mismatches, **result, "ms_by_rows": timings,
          "empty_kernel_ms": floor, "card": card})
    return result


def check_paged_cell(card: str, gen, heads: int = 16) -> dict:
    """The cell paged kernel with append against its plain version at B=32,
    ``heads`` x 64 (16; 8 a model shard's under tp=2), pages of 64 rows,
    capacity 1024: the main path's MHA on f32 and bf16 pools, and GQA
    (``heads`` over a quarter as many kv heads) on f32 pools; empty
    slots, one row, page edges and a slot at capacity whose clipped append
    lands on a row the call reads.  o within 1e-4 (f32 sums in another
    order); the pools after the append equal kv_append's.  Returns the
    largest o error by case."""
    import torch

    from midi_model_tpu_torch.ops import paged_allheads as pa

    dev = torch.device("cuda")
    b, h, d, ps, pps, n_layers = 32, heads, 64, 64, 16, 2
    cap = ps * pps
    lengths = torch.tensor(SMOKE_LENGTHS, dtype=torch.int32, device=dev)
    li = 1
    base = ((li * b + torch.arange(b, device=dev)) * pps).to(torch.int32)
    write_pos = lengths.clamp(0, cap - 1)
    wpages = base + write_pos // ps
    woffs = write_pos % ps
    worst = {}
    for dtype, hkv in ((torch.float32, h), (torch.bfloat16, h), (torch.float32, h // 4)):
        w = hkv * pa.head_stride(d, hkv)
        k_pool = torch.randn((n_layers * b * pps, ps, w), generator=gen, device=dev).to(dtype)
        v_pool = torch.randn((n_layers * b * pps, ps, w), generator=gen, device=dev).to(dtype)
        q = torch.randn((b, h, d), generator=gen, device=dev) * d ** -0.5
        new_k = torch.randn((b, w), generator=gen, device=dev).to(dtype)
        new_v = torch.randn((b, w), generator=gen, device=dev).to(dtype)
        kern = pa.PagedPools(k_pool.clone(), v_pool.clone())
        plain = pa.PagedPools(k_pool.clone(), v_pool.clone())
        kw = dict(page_size=ps, pages_per_slot=pps, kv_heads=hkv, head_dim=d)
        o, m, l, kern = pa.paged_decode_cell(
            q, kern, lengths, base, (new_k, new_v, None, wpages, woffs), **kw)
        o_r, m_r, l_r = pa.decode_reference(q, plain, lengths, base, **kw)
        pa.kv_append(plain, new_k, new_v, wpages, woffs)
        torch.cuda.synchronize()
        live = lengths > 0
        require(torch.equal(kern.k, plain.k) and torch.equal(kern.v, plain.v),
                f"paged {dtype}: pools after append differ from kv_append")
        require(bool((m[~live] == -torch.inf).all() and (l[~live] == 0).all()
                     and (o[~live] == 0).all()), f"paged {dtype}: empty slot stats")
        require(bool(torch.isfinite(o).all()), f"paged {dtype}: non-finite o")
        # f32 rounding only: both sides read the same values and sum in f32
        require(torch.allclose(o[live], o_r[live], atol=1e-4, rtol=1e-4), f"paged {dtype}: o")
        require(torch.allclose(m[live], m_r[live], atol=1e-4, rtol=1e-5), f"paged {dtype}: m")
        require(torch.allclose(l[live], l_r[live], rtol=1e-4), f"paged {dtype}: l")
        worst[f"cell {str(dtype)[6:]} kv_heads={hkv}"] = float((o[live] - o_r[live]).abs().max())
    emit({"phase": "kernel", "name": "paged_decode", "batch": b, "heads": h,
          "head_dim": d, "lengths": lengths.tolist(), "o_max_abs_err": worst, "card": card})
    return worst


def attention_case(b: int, s: int, h: int, hkv: int, dh: int, dtype, strided: bool,
                   timed: bool, g) -> dict:
    """One case of :func:`check_attention` (its checks and, ``timed``, its
    times beside SDPA and its bound); inputs drawn from ``g``."""
    import torch

    from midi_model_tpu_torch.ops import attention as at

    dev = torch.device("cuda")
    f32_tol = dict(atol=5e-5, rtol=1e-4)
    bf16_tol = dict(atol=2e-2, rtol=2e-2)
    bf16, f32 = torch.bfloat16, torch.float32
    name = f"{dtype}[{b},{s},{h},{hkv},{dh}]"
    if strided:
        q = torch.randn((b, s, h, 2 * dh), generator=g, device=dev).to(dtype)[..., :dh]
    else:
        q = torch.randn((b, s, h, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, dh), generator=g, device=dev).to(dtype)
    out = at.causal_attention(q, k, v)
    out_l, lse = at._forward(q, k, v, with_lse=True)
    ref, lse_r = at._reference_with_lse(q, k, v, at.causal_bias(s, dev))
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    lse_err = float((lse - lse_r).abs().max())
    require(bool(torch.isfinite(out.float()).all()), f"causal attention {name}: non-finite")
    require(torch.allclose(out.float(), ref.float(), **(f32_tol if dtype == f32 else bf16_tol)),
            f"causal attention {name}: differs by {float(diff.max())}")
    require(torch.equal(out_l, out), f"causal attention {name}: the output differs "
            f"when the LSE is written")
    require(torch.allclose(lse, lse_r, **LSE_TOL),
            f"causal attention {name}: the LSE differs by {lse_err}")
    case = {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
            "lse_max_abs_err": lse_err}
    del out, out_l, lse, ref, lse_r, diff
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        size = 2 if dtype == bf16 else 4
        # q, k, v read and out written once; two products over the causal pairs
        n_bytes, n_ops = 4 * b * s * h * dh * size, 4 * b * h * dh * s * (s + 1) // 2
        case.update({
            "ms": time_ms(lambda: at.causal_attention(q, k, v), 10),
            "plain_ms": time_ms(lambda: at.attention_reference(
                q, k, v, at.causal_bias(s, dev)), 3),
            # one PyTorch call for the same function, timed here only
            "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 10),
            **bound(n_bytes, n_ops, attention_route(dtype, dh)),
        })
        if dtype == f32:  # the same work on the CUDA cores' f32 rate
            case["bound_ffma_ms"] = bound(n_bytes, n_ops, "f32")["bound_ms"]
    del q, k, v
    torch.cuda.empty_cache()
    return case


def check_attention(card: str, gen) -> dict:
    """The causal attention forward against its plain version
    (``attention_reference`` under the causal bias, on the same inputs):
    bf16 at Dh 64 (the tensor-core kernel) at [4, 2048, 16, 64] with a
    strided q, at the prefill shape [32, 1024, 16, 64] and with GQA (16 over
    4 heads, strided q, S = 2047); the token net's [4094, 8, 4, 256] in bf16
    and f32; f32 (3xTF32 at Dh 64) at the event net's [2, 2047, 16, 64]
    (strided q), the prefill shape and GQA at S = 2047 (strided q), and
    [2, 300, 16, 64] (strided q) and [2, 9, 4, 256].  Timed cases run beside
    one ``scaled_dot_product_attention`` call (timed only, used nowhere),
    with their bound at the rate of the kernel's route (f32 Dh 64: 3xTF32;
    ``bound_ffma_ms`` at the CUDA cores' f32 rate beside it).  f32: within
    atol 5e-5, rtol 1e-4 (f32 rounding; at Dh 64 also the split's ~2^-21).
    bf16: within 2e-2 — the kernels round P to bf16 unnormalized (relative
    to the running row max) before P.V and divide by the row sum at the end,
    the plain version rounds the normalized probabilities; each case's
    largest and mean difference is printed.  Every case also runs the
    forward with its log-sum-exp output (the training forward): the same
    output bit for bit, and the f32 LSE against the plain version's
    (``_reference_with_lse``) within LSE_TOL."""
    import torch

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    # the first three cases draw from the phase's generator, the others from
    # their own, so the later checks' inputs do not depend on this case list
    added = torch.Generator(device=dev)
    added.manual_seed(4321)
    # (B, S, H, Hkv, Dh, dtype, q strided, timed, generator)
    cases = [(2, 300, 16, 16, 64, f32, True, False, gen), (2, 9, 4, 4, 256, f32, True, False, gen),
             (4, 2048, 16, 16, 64, bf16, True, True, gen),
             (32, 1024, 16, 16, 64, bf16, False, True, added),
             (2, 2047, 16, 4, 64, bf16, True, False, added),
             (4094, 8, 4, 4, 256, bf16, False, True, added),
             (4094, 8, 4, 4, 256, f32, False, True, added)]
    # f32 at the event net's training shape, an f32 prefill and GQA with a
    # strided q: their own generator too
    f32_gen = torch.Generator(device=dev)
    f32_gen.manual_seed(4323)
    cases += [(2, 2047, 16, 16, 64, f32, True, True, f32_gen),
              (32, 1024, 16, 16, 64, f32, False, True, f32_gen),
              (2, 2047, 16, 4, 64, f32, True, False, f32_gen)]
    by_case = {}
    for b, s, h, hkv, dh, dtype, strided, timed, g in cases:
        by_case[f"{dtype}[{b},{s},{h},{hkv},{dh}]"] = attention_case(
            b, s, h, hkv, dh, dtype, strided, timed, g)
    result = dict(by_case[f"{bf16}[4,2048,16,16,64]"])
    result["max_abs_err"] = max(c["max_abs_err"] for n, c in by_case.items() if str(bf16) in n)
    result_f32 = dict(by_case[f"{f32}[2,2047,16,16,64]"])
    result_f32["max_abs_err"] = max(c["max_abs_err"] for n, c in by_case.items()
                                    if str(f32) in n)
    emit({"phase": "kernel", "name": "causal_attention", "by_case": by_case, **result,
          "f32": result_f32, "card": card})
    return {"causal_attention": result, "causal_attention_f32": result_f32}


# the cell check's lengths at capacity 1024: empty, one row, page edges, a
# slot at capacity
SMOKE_LENGTHS = ([0, 1, 63, 64, 1000, 1024, 65, 127, 128, 500, 999, 2] * 3)[:32]
# the batcher's ragged lengths at capacity 2048: empty, an inactive slot, one
# 4-page block plus a page, whole blocks, one row, a slot at capacity
RAGGED_LENGTHS = [0, 0, 320, 256, 1, 63, 64, 65, 2048, 1000, 2047, 500, 5, 17, 129, 700] * 2


def check_paged_stream(card: str, gen, heads: int = 16) -> dict:
    """The streaming paged decode on bf16, f32 and int8 pools and the cell
    kernel on int8 pools, against the plain version, at the batcher's
    shapes: B=32, ``heads`` x 64 (16; 8 a model shard's under tp=2), pages
    of 64, capacity 2048.  Ragged
    lengths: 0, an inactive slot (length 0), one full block plus one page
    (320 rows), whole blocks, one row, and a slot at capacity whose clipped
    append lands on a row the call reads; the GQA form too.  o, m, l within
    1e-4 (f32 sums in another order; an int8 value dequantizes to the same
    exact product on both sides); the pools after the append equal
    kv_append's, so every row outside it is untouched.  Returns the largest
    o error by case."""
    import torch

    from midi_model_tpu_torch.ops import paged_allheads as pa

    dev = torch.device("cuda")
    b, h, d, ps, pps, n_layers = 32, heads, 64, 64, 32, 2
    cap = ps * pps
    lengths = torch.tensor(RAGGED_LENGTHS, dtype=torch.int32, device=dev)
    inactive = 1  # the batcher gives an inactive slot length 0
    li = 1
    base = ((li * b + torch.arange(b, device=dev)) * pps).to(torch.int32)
    write_pos = lengths.clamp(0, cap - 1)
    write_pos[inactive] = 700  # an inactive slot still appends, as in decode_paged
    wpages = base + write_pos // ps
    woffs = write_pos % ps
    n_pages = n_layers * b * pps
    live = lengths > 0
    worst = {}

    def pools_of(dtype, w):
        if dtype == torch.int8:
            k = torch.randint(-127, 128, (n_pages, ps, w), generator=gen, device=dev,
                              dtype=torch.int8)
            v = torch.randint(-127, 128, (n_pages, ps, w), generator=gen, device=dev,
                              dtype=torch.int8)
            sc = (torch.rand((n_pages, ps, pa.LANE), generator=gen, device=dev) * 0.02
                  + 1e-3).to(torch.bfloat16)
            return pa.PagedPools(k, v, sc)
        return pa.PagedPools(
            torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype),
            torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype))

    def rows_of(pools, w):
        if pools.quantized:
            new = [torch.randint(-127, 128, (b, w), generator=gen, device=dev,
                                 dtype=torch.int8) for _ in range(2)]
            return new + [(torch.rand((b, pa.LANE), generator=gen, device=dev) * 0.02
                           ).to(torch.bfloat16)]
        return [torch.randn((b, w), generator=gen, device=dev).to(pools.k.dtype)
                for _ in range(2)] + [None]

    def clone(pools):
        return pa.PagedPools(*(None if t is None else t.clone() for t in pools))

    cases = [("bf16", torch.bfloat16, h, True), ("f32", torch.float32, h, True),
             ("int8", torch.int8, h, True), ("int8 cell", torch.int8, h, False),
             ("f32 gqa", torch.float32, h // 4, True), ("int8 gqa", torch.int8, h // 4, True)]
    for name, dtype, hkv, streaming in cases:
        decode = pa.paged_decode_stream if streaming else pa.paged_decode_cell
        w = hkv * pa.head_stride(d, hkv)
        pools = pools_of(dtype, w)
        q = torch.randn((b, h, d), generator=gen, device=dev) * d ** -0.5
        new_k, new_v, new_s = rows_of(pools, w)
        write = (new_k, new_v, new_s, wpages, woffs)
        kw = dict(page_size=ps, pages_per_slot=pps, kv_heads=hkv, head_dim=d)
        kern, plain = clone(pools), clone(pools)
        o, m, l, kern = decode(q, kern, lengths, base, write, **kw)
        o_r, m_r, l_r = pa.decode_reference(q, plain, lengths, base, **kw)
        pa.kv_append(plain, new_k, new_v, wpages, woffs, new_s)
        torch.cuda.synchronize()
        for ours, ref in zip(kern, plain):
            if ours is not None:
                require(torch.equal(ours, ref), f"paged {name}: pools after append differ")
        require(bool((m[~live] == -torch.inf).all() and (l[~live] == 0).all()
                     and (o[~live] == 0).all()), f"paged {name}: empty slot stats")
        require(bool(torch.isfinite(o).all()), f"paged {name}: non-finite o")
        require(torch.allclose(o[live], o_r[live], atol=1e-4, rtol=1e-4), f"paged {name}: o")
        require(torch.allclose(m[live], m_r[live], atol=1e-4, rtol=1e-5), f"paged {name}: m")
        require(torch.allclose(l[live], l_r[live], rtol=1e-4), f"paged {name}: l")
        worst[name] = float((o[live] - o_r[live]).abs().max())
        del pools, kern, plain
    emit({"phase": "kernel", "name": "paged_decode_stream+int8", "batch": b, "heads": h,
          "head_dim": d, "lengths": lengths.tolist(), "inactive_slot": inactive,
          "o_max_abs_err": worst, "card": card})
    return worst


# a sweep of one timed case's page sets must overflow the 50 MB L2 twice
COLD_SWEEP_BYTES = 100e6


def paged_bytes(lengths, b: int, h: int, hkv: int, d: int, w: int, dtype,
                append: bool = True) -> int:
    """The bytes a paged decode call (with append) must move: each live
    row's k and v once (int8: one bf16 k and one v scale per kv head), q
    in, o, m, l out, the appended rows in and out (int8: with their scale
    row), and the four int32 vectors."""
    import torch

    from midi_model_tpu_torch.ops import paged_allheads as pa

    elt = torch.empty((), dtype=dtype).element_size()
    row = 2 * w * elt + (2 * hkv * 2 if dtype == torch.int8 else 0)
    append = (2 * 2 * b * w * elt + (2 * b * pa.LANE * 2 if dtype == torch.int8 else 0)
              if append else 0)
    return int(sum(lengths)) * row + b * h * d * 4 * 2 + b * h * 8 + append + b * 16


def kernels_per_call(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def time_paged_cell_vs_stream(card: str) -> dict:
    """The cell and the streaming paged kernels timed with a cold L2 on the
    same inputs: B=32, 16 heads x 64, pages of 64, capacity 2048, on bf16,
    f32 and int8 pools, at the smoke's lengths (``SMOKE_LENGTHS``), every
    slot at one length (``generate``'s split path: 64-192 rows go to the
    cell kernel, 256-2047 to the streaming one) and the batcher's ragged
    lengths; GQA (kv_heads 4, bf16 pools) at 128 rows and ragged.  Each
    timed call reads another layer's pages (base ``(li * B + slot) * pps``,
    as ``decode_paged``), over enough layers that one sweep reads more than
    ``COLD_SWEEP_BYTES``.  Per case: device ms per call of each kernel
    (``time_ms``), the host's ms to issue one call, the plain version's ms
    (warm, a yardstick), the byte bound; o of the two kernels within 1e-4;
    and the device kernels one call of each wrapper launches."""
    import math

    import torch

    from midi_model_tpu_torch.ops import paged_allheads as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    b, h, d, ps, pps = 32, 16, 64, 64, 32
    cap = ps * pps
    q = torch.randn((b, h, d), generator=gen, device=dev) * d ** -0.5
    shapes = {"smoke": SMOKE_LENGTHS, "ragged": RAGGED_LENGTHS}
    shapes.update({f"uniform {n}": [n] * b for n in (64, 128, 192, 256, 1024, 2047)})
    cases = [(name, dtype, 16, shape) for name, dtype in
             (("bf16", torch.bfloat16), ("f32", torch.float32), ("int8", torch.int8))
             for shape in shapes]
    cases += [("bf16 gqa", torch.bfloat16, 4, "uniform 128"), ("bf16 gqa", torch.bfloat16, 4,
                                                               "ragged")]
    by_case, per_call = {}, {}
    for pool_name in dict.fromkeys(c[0] for c in cases):
        mine = [c for c in cases if c[0] == pool_name]
        _, dtype, hkv, _ = mine[0]
        w = hkv * pa.head_stride(d, hkv)
        need = {shape: max(2, math.ceil(COLD_SWEEP_BYTES / paged_bytes(
            shapes[shape], b, h, hkv, d, w, dtype)) + 1) for _, _, _, shape in mine}
        n_layers = max(need.values())
        n_pages = n_layers * b * pps
        if dtype == torch.int8:
            pools = pa.PagedPools(*(torch.randint(-127, 128, (n_pages, ps, w), generator=gen,
                                                  device=dev, dtype=torch.int8)
                                    for _ in range(2)),
                                  (torch.rand((n_pages, ps, pa.LANE), generator=gen,
                                              device=dev) * 0.02 + 1e-3).to(torch.bfloat16))
            rows = [torch.randint(-127, 128, (b, w), generator=gen, device=dev,
                                  dtype=torch.int8) for _ in range(2)]
            rows.append((torch.rand((b, pa.LANE), generator=gen, device=dev) * 0.02
                         ).to(torch.bfloat16))
        else:
            pools = pa.PagedPools(*(torch.randn((n_pages, ps, w), generator=gen,
                                                device=dev).to(dtype) for _ in range(2)))
            rows = [torch.randn((b, w), generator=gen, device=dev).to(dtype)
                    for _ in range(2)] + [None]
        kw = dict(page_size=ps, pages_per_slot=pps, kv_heads=hkv, head_dim=d)
        for _, _, _, shape in mine:
            lens = shapes[shape]
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            pos = lengths.clamp(max=cap - 1)
            layers = []
            for li in range(need[shape]):
                base = ((li * b + torch.arange(b, device=dev)) * pps).to(torch.int32)
                layers.append((base, (*rows, base + pos // ps, pos % ps)))
            n_bytes = paged_bytes(lens, b, h, hkv, d, w, dtype)
            case = {"layers_swept": need[shape], "mb_per_call": n_bytes / 1e6,
                    **bound(n_bytes, sum(lens) * h * d * 4,
                            {torch.int8: "int8", torch.bfloat16: "bf16"}.get(dtype, "f32"))}
            outs = {}
            for kernel, decode, extra in (
                    ("cell", pa.paged_decode_cell, {"max_length": max(lens)}),
                    ("streaming", pa.paged_decode_stream, {})):
                calls = [lambda base=base, write=write: decode(
                    q, pools, lengths, base, write, **kw, **extra) for base, write in layers]
                calls[0]()  # the appends written: later calls read the same rows
                outs[kernel] = calls[0]()[0]
                case[f"{kernel}_ms"] = time_ms(calls, 200)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(200):
                    calls[i % len(calls)]()
                case[f"{kernel}_issue_ms"] = (time.perf_counter() - t0) * 1e3 / 200
                torch.cuda.synchronize()
                case[f"{kernel}_of_bound"] = case["bound_ms"] / case[f"{kernel}_ms"]
                if shape in ("ragged", "uniform 128") and pool_name in ("int8", "bf16 gqa"):
                    per_call[f"{kernel} {pool_name} {shape}"] = kernels_per_call(calls[0])
            # the plain append writes the rows the kernels wrote
            case["plain_ms"] = time_ms(lambda: pa._plain(q, pools, lengths, *layers[0], kw), 3)
            require(torch.allclose(outs["cell"], outs["streaming"], atol=1e-4, rtol=1e-4),
                    f"paged {pool_name} {shape}: the kernels differ")
            by_case[f"{pool_name} {shape}"] = case
        del pools, rows
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "paged_decode_cell_vs_stream", "batch": b, "heads": h,
          "head_dim": d, "cold_sweep_bytes": COLD_SWEEP_BYTES, "by_case": by_case,
          "kernels_per_call": per_call, "card": card})
    return by_case


def paged_kernel_rows(by_case: dict, worst: dict) -> dict:
    """The kernels line's paged rows from the cold timings, at the shapes of
    the earlier rows: the cell kernel on bf16 pools at the smoke's lengths
    and on int8 pools at the ragged ones, the streaming kernel on int8
    pools at the ragged ones."""
    rows = {}
    for name, case, kernel in (("paged_decode", "bf16 smoke", "cell"),
                               ("paged_decode_int8", "int8 ragged", "cell"),
                               ("paged_decode_stream", "int8 ragged", "streaming")):
        c = by_case[case]
        rows[name] = {"ms": c[f"{kernel}_ms"], "plain_ms": c["plain_ms"], "library_ms": None,
                      "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                      "max_abs_err": max(worst.values())}
    return rows


def check_token_row(card: str, gen) -> dict:
    """The token-row kernel against its plain version at tv2o-medium, B=32:
    f32 rows identical (greedy and sampled, over per-row knobs, allow-plane
    and forced-pad rows); bf16 greedy rows identical up to near-ties, sampled
    share printed.  Then bf16 at granite-4.0-h-micro's token net (D = W = F =
    2048, 3 layers, heads of 256; ``bench_h100/configs/tv2o-granite-h-
    micro.json``), B=32, where each RMSNorm row is wider than one staged
    segment: the same cases and rule, and one launch with the phase clock."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig, TransformerConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import token_loop as tl
    from midi_model_tpu_torch.sampling import (build_allow_vector, build_mask_table,
                                               gumbel_rows, mask_tensors)

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    tok = config.tokenizer
    b, t_max = 32, tok.max_token_seq
    masks = mask_tensors(build_mask_table(tok), dev)
    hidden = torch.randn((b, config.n_embd), generator=gen, device=dev)
    temp = torch.tensor([1.0, 0.8, 1.2, 1.0] * 8, device=dev)
    top_p = torch.tensor([0.98, 0.9, 1.0, 0.5] * 8, device=dev)
    top_k = torch.tensor([20, 8, 1, 64] * 8, dtype=torch.int32, device=dev)
    allow = np.ones((b, tok.vocab_size), bool)
    allow[0] = build_allow_vector(tok, disable_patch_change=True, disable_channels=[1, 3])
    allow[5] = build_allow_vector(tok, disable_control_change=True)
    allow = torch.as_tensor(allow, device=dev)
    forced = torch.zeros(b, dtype=torch.bool, device=dev)
    forced[[3, 17]] = True
    cases = {"greedy": dict(greedy=True),
             "sampled": dict(greedy=False),
             "greedy_allow_forced": dict(greedy=True, allow=allow, forced_pad=forced),
             "sampled_allow_forced": dict(greedy=False, allow=allow, forced_pad=forced)}
    out, gaps = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_model(config, seed=0, dtype=dtype, device=dev)
        same = {}
        for name, kw in cases.items():
            g = gumbel_rows(b, t_max, gen)
            args = (model, config, hidden, masks, temp, top_p, top_k, g)
            row, ended = tl.decode_token_row(*args, **kw)
            row_r, ended_r = tl.decode_token_row_reference(*args, **kw)
            torch.cuda.synchronize()
            identical = (row == row_r).all(dim=1)
            require(torch.equal(ended, ended_r) or dtype == torch.bfloat16,
                    f"token row {dtype} {name}: ended differs")
            same[name] = float(identical.float().mean())
            if kw.get("forced_pad") is not None:
                require(bool((row[forced] == tok.pad_id).all()),
                        f"token row {dtype} {name}: forced rows not all pad")
            if dtype == torch.float32:
                bad = (~identical).nonzero().flatten().tolist()
                require(bool(identical.all()),
                        f"token row {dtype} {name}: rows {bad} differ:\n"
                        f"{row[~identical].tolist()}\n{row_r[~identical].tolist()}")
            elif kw["greedy"]:
                # bf16 with random weights (std 0.02): logits are nearly flat, so
                # a greedy pick may be a near-tie that the two sides' rounding
                # of f32 sums (summed in another order) decides differently.  Every
                # differing row must be such a tie: the plain version's winner
                # beats the kernel's pick by at most a few bf16 steps.
                gaps[name] = tie_gaps(model, hidden, row, row_r, temp)
                require(same[name] >= 0.9 and all(abs(x) <= 0.0625 for x in gaps[name]),
                        f"token row {dtype} {name}: identical share {same[name]}, "
                        f"logit gaps of the differing picks {gaps[name]}")
        out[str(dtype)] = same
        if dtype == torch.bfloat16:  # the main path's dtype and knobs
            g = gumbel_rows(b, t_max, gen)
            args = (model, config, hidden, masks, 1.0, 0.98, 20, g)
            timing = {"ms": time_ms(lambda: tl.decode_token_row(*args, greedy=False), 20),
                      "plain_ms": time_ms(lambda: tl.decode_token_row_reference(
                          *args, greedy=False), 3),
                      "library_ms": None,
                      # the weights counted once: the L2-resident floor
                      **bound(2 * tok_net_params(model) + b * config.n_embd * 2
                              + t_max * b * 128 * 4, 2 * b * t_max * tok_net_params(model),
                              "bf16")}
            # the weights read once a step, from HBM
            each_step = bound(2 * t_max * tok_net_params(model) + b * config.n_embd * 2
                              + t_max * b * 128 * 4, 2 * b * t_max * tok_net_params(model),
                              "bf16")["bound_ms"]
            kinds = tl.phase_kinds(config.net_token.num_layers, t_max)
            clock = tl.phase_clock(len(kinds) - 1, dev)
            tl.decode_token_row(*args, greedy=False, clock=clock)
            clocked = phase_clock_summary(clock, kinds)
            # the UI's largest top_k: the sample phase selects 128 ranks a row
            args_128 = (model, config, hidden, masks, 1.0, 0.98, 128, g)
            timing["ms_top_k_128"] = time_ms(
                lambda: tl.decode_token_row(*args_128, greedy=False), 20)
            clock = tl.phase_clock(len(kinds) - 1, dev)
            tl.decode_token_row(*args_128, greedy=False, clock=clock)
            clocked_128 = phase_clock_summary(clock, kinds)
        del model
        torch.cuda.empty_cache()
    result = {"max_abs_err": 1.0 - min(out["torch.float32"].values()), **timing}
    emit({"phase": "kernel", "name": "token_row", "batch": b,
          "identical_row_share": out, "bf16_greedy_tie_logit_gaps": gaps, **result,
          "bound_ms_weights_each_step": each_step, "bf16_phase_clock": clocked,
          "bf16_phase_clock_top_k_128": clocked_128,
          "sample_us": {"top_k_20": clocked["us_per_phase"]["sample"],
                        "top_k_128": clocked_128["us_per_phase"]["sample"]},
          "card": card})

    # granite's token net (the event net, never run here, a one-layer stand-in)
    wide = MIDIModelConfig(tok, TransformerConfig(tok.vocab_size, 2048, 1, 16, 2048),
                           TransformerConfig(tok.vocab_size, 2048, 3, 8, 2048))
    model = init_model(wide, seed=0, dtype=torch.bfloat16, device=dev)
    hidden = torch.randn((b, wide.n_embd), generator=gen, device=dev)
    same, gaps = {}, {}
    for name, kw in cases.items():
        g = gumbel_rows(b, t_max, gen)
        args = (model, wide, hidden, masks, temp, top_p, top_k, g)
        row, _ = tl.decode_token_row(*args, **kw)
        row_r, _ = tl.decode_token_row_reference(*args, **kw)
        torch.cuda.synchronize()
        same[name] = float((row == row_r).all(dim=1).float().mean())
        if kw.get("forced_pad") is not None:
            require(bool((row[forced] == tok.pad_id).all()),
                    f"token row D=2048 {name}: forced rows not all pad")
        if kw["greedy"]:  # the near-tie rule of tv2o-medium's bf16 rows
            gaps[name] = tie_gaps(model, hidden, row, row_r, temp)
            require(same[name] >= 0.9 and all(abs(x) <= 0.0625 for x in gaps[name]),
                    f"token row D=2048 {name}: identical share {same[name]}, "
                    f"logit gaps of the differing picks {gaps[name]}")
    g = gumbel_rows(b, t_max, gen)
    args = (model, wide, hidden, masks, 1.0, 0.98, 20, g)
    wide_ms = time_ms(lambda: tl.decode_token_row(*args, greedy=False), 20)
    kinds = tl.phase_kinds(wide.net_token.num_layers, t_max)
    clock = tl.phase_clock(len(kinds) - 1, dev)
    tl.decode_token_row(*args, greedy=False, clock=clock)
    emit({"phase": "kernel", "name": "token_row_d2048", "batch": b,
          "identical_row_share": same, "bf16_greedy_tie_logit_gaps": gaps, "ms": wide_ms,
          "bf16_phase_clock": phase_clock_summary(clock, kinds), "card": card})
    del model
    torch.cuda.empty_cache()
    return result


def phase_clock_summary(clock, kinds) -> dict:
    """Mean µs per phase kind of one clocked launch (``ops.token_loop.
    phase_clock``): a phase's work runs from its start to the last block's
    arrival at the barrier that ends it; the barrier's wait from that
    arrival to the next phase's start."""
    import numpy as np

    c = clock.cpu().numpy().astype(np.int64)
    n = len(kinds)
    require(bool((c[:2 * n] > 0).all()), f"phase clock: unstamped entries {c[:2 * n].tolist()}")
    work = (c[1:2 * n:2] - c[0:2 * n:2]) / 1e3
    wait = (c[2:2 * n:2] - c[1:2 * n - 1:2]) / 1e3
    out = {kind: float(np.mean([w for k, w in zip(kinds, work) if k == kind]))
           for kind in dict.fromkeys(kinds)}
    return {"us_per_phase": out, "barrier_wait_us": float(np.mean(wait)),
            "phases": n, "total_us": float((c[2 * n - 1] - c[0]) / 1e3),
            "work_us": float(work.sum()), "wait_us": float(wait.sum())}


def tie_gaps(model, hidden, row, row_r, temp) -> list:
    """For each row where the kernel's greedy row differs from the plain
    version's: at the first differing step, the plain version's logit (over
    temp) of its own pick minus that of the kernel's pick, from a
    teacher-forced pass over the shared prefix."""
    import torch

    gaps = []
    with torch.no_grad():
        for r in (row != row_r).any(dim=1).nonzero().flatten().tolist():
            j = int((row[r] != row_r[r]).nonzero()[0])
            logits, _ = model.forward_token(hidden[r:r + 1], row_r[r:r + 1, :j] if j else None)
            lg = logits[0, -1] / temp[r]
            gaps.append(float(lg[row_r[r, j]] - lg[row[r, j]]))
    return gaps


def check_fused_step(card: str, gen) -> dict:
    """The whole-step kernel against its plain version at tv2o-medium, B=32,
    pages of 64, capacity 1024, lengths mixed over 0..1024 with one slot at
    capacity (its clipped write lands on a row the step reads) and one
    inactive slot.  Rows outside the append stay bit-identical.  f32: hidden
    and appended rows within 1e-4.  bf16: within 3e-2 after one layer and
    BF16_DEEP_TOL after all 12; the plain version on the CPU against the
    plain version on the card is printed beside it.  Then two bf16 launches
    of all 12 layers are timed with the phase clock (``timed_step_case``).
    """
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import paged_allheads as pa
    from midi_model_tpu_torch.ops import token_loop as tl

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    b, ps, pps = 32, 64, 16
    cap = ps * pps
    index = torch.tensor([0, 1, 63, 64, 1000, cap, 65, 127, 128, 500, 999, 2] * 3,
                         dtype=torch.int32, device=dev)[:b]
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[7] = False
    x = torch.randn((b, config.net.hidden_size), generator=gen, device=dev) * 0.1
    w = config.net.num_heads * config.net.head_dim
    kw = dict(page_size=ps, pages_per_slot=pps)

    def step(fused, n_layers, k0, v0):
        """Kernel, plain version and their pools over the first n_layers."""
        net = type(config.net)(**{**config.net.__dict__, "num_layers": n_layers})
        fused = fs.FusedWeights(*(t[:n_layers] for t in fused[:5]), fused.final_norm)
        n_pages = n_layers * b * pps
        kern = pa.PagedPools(k0[:n_pages].clone(), v0[:n_pages].clone())
        plain = pa.PagedPools(k0[:n_pages].clone(), v0[:n_pages].clone())
        h, _ = fs.fused_decode_step(fused, net, x, kern, index, active, **kw)
        h_r, _ = fs.fused_decode_step_reference(fused, net, x, plain, index, active, **kw)
        torch.cuda.synchronize()
        return net, fused, h, h_r, kern, plain

    def appended(n_layers):
        """[n_pages, ps] mask of the rows a step appends: every slot of every
        layer at clip(index, 0, cap-1)."""
        wpos = index.clamp(0, cap - 1).long()
        page = ((torch.arange(n_layers * b, device=dev) * pps).view(n_layers, b)
                + wpos // ps).flatten()
        mask = torch.zeros((n_layers * b * pps, ps), dtype=torch.bool, device=dev)
        mask[page, (wpos % ps).repeat(n_layers)] = True
        return mask

    def err(a, b_):
        return float((a.float() - b_.float()).abs().max())

    errs, result = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_model(config, seed=1, dtype=dtype, device=dev)
        full = fs.prepare_fused(model.net)
        del model
        n_pages = config.net.num_layers * b * pps
        k0 = torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype)
        v0 = torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype)
        case = {}
        for n_layers in (1, config.net.num_layers):
            net, fused, h, h_r, kern, plain = step(full, n_layers, k0, v0)
            written = appended(n_layers)
            require(bool(torch.isfinite(h.float()).all()), f"fused step {dtype}: non-finite")
            for ours, ref, before in ((kern.k, plain.k, k0), (kern.v, plain.v, v0)):
                before = before[:ours.shape[0]]
                require(torch.equal(ours[~written], before[~written])
                        and torch.equal(ref[~written], before[~written]),
                        f"fused step {dtype}: a row outside the append changed")
            got = {"hidden": err(h, h_r),
                   "appended_rows": max(err(kern.k[written], plain.k[written]),
                                        err(kern.v[written], plain.v[written]))}
            if dtype == torch.float32 or n_layers == 1:
                tol = 1e-4 if dtype == torch.float32 else 3e-2
                require(torch.allclose(h.float(), h_r.float(), atol=tol, rtol=tol)
                        and torch.allclose(kern.k[written].float(), plain.k[written].float(),
                                           atol=tol, rtol=tol)
                        and torch.allclose(kern.v[written].float(), plain.v[written].float(),
                                           atol=tol, rtol=tol),
                        f"fused step {dtype}, {n_layers} layers: {got}")
            else:
                cpu = pa.PagedPools(k0.cpu(), v0.cpu())
                h_c, _ = fs.fused_decode_step_reference(
                    fs.FusedWeights(*(t.cpu() for t in fused)), net, x.cpu(), cpu,
                    index.cpu(), active.cpu(), **kw)
                written_c = written.cpu()
                got["plain_cpu_vs_plain_card"] = {
                    "hidden": err(h_c, h_r.cpu()),
                    "appended_rows": max(err(cpu.k[written_c], plain.k[written].cpu()),
                                         err(cpu.v[written_c], plain.v[written].cpu()))}
                for key in ("hidden", "appended_rows"):
                    require(got[key] <= BF16_DEEP_TOL,
                            f"fused step {dtype}: {key} differs by {got[key]} > "
                            f"{BF16_DEEP_TOL}")
            case[f"{n_layers}_layers"] = got
            if dtype == torch.bfloat16 and n_layers == config.net.num_layers:
                weights = sum(t.numel() for t in fused[:5])
                cached = int(index.clamp(max=cap)[active].sum()) * n_layers
                result = {"ms": time_ms(lambda: fs.fused_decode_step(
                              fused, net, x, kern, index, active, **kw), 20),
                          "plain_ms": time_ms(lambda: fs.fused_decode_step_reference(
                              fused, net, x, plain, index, active, **kw), 3),
                          "library_ms": None,
                          **bound(2 * (weights + cached * 2 * w + n_layers * b * 2 * w),
                                  2 * b * weights + 4 * cached * w, "bf16")}
                kinds = fs.phase_kinds(n_layers)
                clock = tl.phase_clock(len(kinds) - 1, dev)
                fs.fused_decode_step(fused, net, x, kern, index, active, **kw, clock=clock)
                clocked = phase_clock_summary(clock, kinds)
                clocked["attention_floor_us"] = attention_floor_us(
                    index.clamp(max=cap)[active], w)
                del kern, plain
                result["timed_cases"] = {
                    "app_steady_like": timed_step_case(fused, net, "steady", card),
                    "app_prompt_like": timed_step_case(fused, net, "prompt", card)}
                continue
            del kern, plain
        errs[str(dtype)] = case
        del full, k0, v0
        torch.cuda.empty_cache()
    result["max_abs_err"] = errs["torch.float32"][f"{config.net.num_layers}_layers"]["hidden"]
    emit({"phase": "kernel", "name": "fused_step", "batch": b, "index": index.tolist(),
          "max_abs_err_by_dtype": errs, **result, "bf16_phase_clock": clocked, "card": card})
    return result


def attention_floor_us(lengths, w: int) -> float:
    """The whole step's attention phase's byte floor a layer, in µs: the
    live slots' cached k and v rows read once, bf16, at the HBM rate."""
    return float(lengths.sum()) * 2 * w * 2 / HBM_BYTES_PER_S * 1e6


def timed_step_case(fused, net, kind: str, card: str) -> dict:
    """One bf16 whole step of all layers timed, with its phase clock, on
    random pools (pages of 64) from a generator of its own: "steady", 32
    slots of log-uniform 16-1,536 rows (capacity 2,048), as app_steady's
    sessions; "prompt", 8 live slots of 1,024-3,968 rows and 24 inactive
    (capacity 4,096), as app_prompt's."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import paged_allheads as pa
    from midi_model_tpu_torch.ops import token_loop as tl

    dev = torch.device("cuda")
    rng = np.random.default_rng(17 if kind == "steady" else 18)
    b, ps = 32, 64
    if kind == "steady":
        pps = 32
        lengths = np.exp(rng.uniform(np.log(16), np.log(1536), b)).astype(np.int64)
        live = np.ones(b, bool)
    else:
        pps = 64
        lengths = np.zeros(b, np.int64)
        live = np.zeros(b, bool)
        slots = rng.choice(b, 8, replace=False)
        lengths[slots] = rng.integers(1024, 3969, 8)
        live[slots] = True
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    w = net.num_heads * net.head_dim
    n_pages = net.num_layers * b * pps
    pools = pa.PagedPools(
        *(torch.randn((n_pages, ps, w), generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(2)))
    x = torch.randn((b, net.hidden_size), generator=gen, device=dev).to(torch.bfloat16) * 0.1
    index = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    active = torch.as_tensor(live, device=dev)
    kw = dict(page_size=ps, pages_per_slot=pps)
    ms = time_ms(lambda: fs.fused_decode_step(fused, net, x, pools, index, active, **kw), 20)
    kinds = fs.phase_kinds(net.num_layers)
    clock = tl.phase_clock(len(kinds) - 1, dev)
    h, _ = fs.fused_decode_step(fused, net, x, pools, index, active, **kw, clock=clock)
    require(bool(torch.isfinite(h.float()).all()), f"timed step {kind}: non-finite")
    chunk, items = fs.attention_plan(lengths, live)
    weights = sum(t.numel() for t in fused[:5])
    cached = int(lengths[live].sum()) * net.num_layers
    out = {"lengths": lengths.tolist(), "live": int(live.sum()), "chunk": chunk,
           "items": int(items.sum()), "split_slots": int((items > 1).sum()), "ms": ms,
           **bound(2 * (weights + cached * 2 * w + net.num_layers * b * 2 * w),
                   2 * b * weights + 4 * cached * w, "bf16"),
           "phase_clock": phase_clock_summary(clock, kinds),
           "attention_floor_us": attention_floor_us(lengths[live], w), "card": card}
    del pools
    torch.cuda.empty_cache()
    return out


def int8_kernel_qkv(fused, net, x, pools, index, active, *, page_size: int,
                    pages_per_slot: int):
    """One launch of the whole step's int8 form (f32 weights) as
    ``fused_decode_step`` makes it, returning the kernel's own q/k/v rows of
    its last layer [B, 3W] (its scratch).  The pools are read, not written;
    the launch is not counted."""
    import torch

    from midi_model_tpu_torch.models.llama import rope_cos_sin
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.ops import fused_step as fs

    b = x.shape[0]
    w = net.num_heads * net.head_dim
    index, lengths, wpos = fs._slot_tables(index, active, b, page_size * pages_per_slot,
                                           x.device)
    cos, sin = rope_cos_sin(index[None, :], net.head_dim, net.rope_theta)
    bar = torch.zeros(2, dtype=torch.int32, device=x.device)
    ptrs, ints, floats, _, _, keep = fs.kernel_args(
        fused, net, x, pools, lengths[None], wpos[None], cos.contiguous(), sin.contiguous(),
        page_size=page_size, pages_per_slot=pages_per_slot, bar=bar)
    _build.call_packed("mm_fused_step_f32_int8", ptrs, ints, floats, x.device)
    torch.cuda.synchronize()
    return next(t for t in keep if t is not None and tuple(t.shape) == (b, 3 * w)).clone()


def int8_aligned_layer(fused, net, x, pools, index, active, kernel_qkv, *, page_size: int,
                       pages_per_slot: int):
    """One layer of the whole step on int8 pools with f32 weights, as its
    plain version computes it, except where the plain version and the
    kernel may round a v-scaled softmax weight ``p * v_scale`` to bf16 on
    two sides of a rounding midpoint: those weights take the kernel's
    rounding.  A weight may flip when it lies within the f32 error of the
    plain scores (at most ``dh * 2**-23`` times sum |q_d k_d| k_scale for
    the score and for the row's max) and of exp (2**-20) of a midpoint.
    The kernel's rounding is recomputed from the kernel's own q/k rows
    (``kernel_qkv``) with its arithmetic: RoPE without contraction, the
    score as one f32 fma chain over the head dims in order (emulated in
    f64, each step rounded to f32), times the k scale, exp against the row
    maximum, times the v scale, rounded to bf16.  A weight whose recomputed
    value is itself within two f32 steps of exp of the midpoint cannot be
    aligned: it keeps a first-order bound of its flip, pushed through o,
    the merge with the fresh row, o-proj and the absolute Jacobian of the
    rest of the layer (the MLP residual and the final norm).  ``pools`` are
    layer 0's pools before the step.  Returns (hidden with the aligned
    weights, the same without aligning — the plain version replayed —, the
    bound [B, D], weights at a midpoint, weights not aligned)."""
    import torch
    import torch.nn.functional as F

    from midi_model_tpu_torch.models.llama import apply_rope, rms_norm, rope_cos_sin
    from midi_model_tpu_torch.ops import paged_allheads as pa

    b = x.shape[0]
    h_n, dh = net.num_heads, net.head_dim
    w = h_n * dh
    eps = net.rms_norm_eps
    cap = page_size * pages_per_slot
    pages = b * pages_per_slot
    idx = index.long()
    lengths = torch.where(active, idx.clamp(max=cap), 0)
    valid = torch.arange(cap, device=x.device)[None, None, :] < lengths[:, None, None]
    cos, sin = rope_cos_sin(idx[:, None], dh, net.rope_theta)
    scales = pools.scales[:pages].view(b, cap, pa.LANE).float().transpose(1, 2)
    ks, vs = scales[:, :h_n], scales[:, h_n:2 * h_n]  # [B, H, cap]
    kc = pools.k[:pages].view(b, cap, h_n, dh).float()
    vc = pools.v[:pages].view(b, cap, h_n, dh).float()

    def query(qkv):  # the scaled query and the fresh k, v rows
        qkv = qkv.view(b, 1, 3, h_n, dh)
        return (apply_rope(qkv[:, :, 0], cos, sin)[:, 0] * dh ** -0.5,
                apply_rope(qkv[:, :, 1], cos, sin)[:, 0], qkv[:, 0, 2])

    qkv = F.linear(rms_norm(x, fused.ln[0, 0], eps), fused.wqkv[0])
    qs, kr, v = query(qkv)
    scores = torch.where(valid, torch.einsum("bhd,bthd->bht", qs, kc) * ks, -torch.inf)
    err = dh * 2.0 ** -23 * torch.einsum("bhd,bthd->bht", qs.abs(), kc.abs()) * ks
    m = scores.max(dim=-1, keepdim=True)
    pexp = torch.where(valid, torch.exp(scores - m.values), 0.0)
    l = pexp.sum(dim=-1).clamp(min=1e-30)
    wt = pexp * vs

    def midpoint(t):  # the bf16 midpoint next to t, and the bf16 step there
        lo = (t.view(torch.int32) & -65536).view(torch.float32)  # the bf16 value at or below
        step = (lo.view(torch.int32) + 65536).view(torch.float32) - lo
        return lo + step / 2, step

    mid, step = midpoint(wt)
    near = valid & ((wt - mid).abs() <= wt * (err + err.gather(-1, m.indices) + 2.0 ** -20))
    # the kernel's weights from its own q/k rows and its own arithmetic
    qs_k, _, _ = query(kernel_qkv.float())
    s_k = torch.zeros_like(scores, dtype=torch.float64)
    for d in range(dh):
        s_k = (s_k + qs_k[:, :, None, d].double()
               * kc[:, :, :, d].transpose(1, 2).double()).float().double()
    s_k = torch.where(valid, s_k.float() * ks, -torch.inf)
    wt_k = torch.where(valid, torch.exp(s_k - s_k.max(dim=-1, keepdim=True).values), 0.0) * vs
    mid_k, _ = midpoint(wt_k)
    unaligned = near & ((wt_k - mid_k).abs() <= wt_k * 2.0 ** -21)
    aligned = torch.where(near, wt_k.to(torch.bfloat16), wt.to(torch.bfloat16)).float()

    s_self = (qs * kr).sum(dim=-1)
    m2 = torch.maximum(m.values[..., 0], s_self)
    w_cache = l * torch.exp(m.values[..., 0] - m2)
    w_self = torch.exp(s_self - m2)
    share = w_cache / (w_cache + w_self)
    f = fused.wgu.shape[1] // 2

    def rest(y):  # the MLP residual and the final norm
        gate, up = F.linear(rms_norm(y, fused.ln[0, 1], eps), fused.wgu[0]).split(f, dim=-1)
        return rms_norm(y + F.linear(F.silu(gate) * up, fused.wd[0]), fused.final_norm, eps)

    def layer(weights):
        o = torch.einsum("bht,bthd->bhd", weights, vc) / l[..., None]
        attn = (w_cache[..., None] * o + w_self[..., None] * v) / (w_cache + w_self)[..., None]
        x1 = x + F.linear(attn.reshape(b, w), fused.wo[0])
        return x1, rest(x1)

    x1, h_aligned = layer(aligned)
    _, h_plain = layer(wt.to(torch.bfloat16).float())
    bound = torch.zeros_like(x)
    bi, hi, ti = unaligned.nonzero().unbind(1)
    if len(bi):
        jac = torch.func.vmap(torch.func.jacrev(rest))(x1)  # [B, D, D]
        moved = torch.zeros((len(bi), h_n, dh), device=x.device)
        moved[torch.arange(len(bi), device=x.device), hi] = (
            vc[bi, ti, hi] * (step[bi, hi, ti] / l[bi, hi] * share[bi, hi])[:, None])
        moved = F.linear(moved.view(len(bi), -1), fused.wo[0])
        for slot in range(b):
            bound[slot] = (moved[bi == slot] @ jac[slot].T).abs().sum(dim=0)
    return h_aligned, h_plain, bound, int(near.sum()), len(bi)


def check_fused_step_int8(card: str, gen) -> dict:
    """The whole-step kernel's int8 form against its plain version at
    tv2o-medium, B=32, pages of 64, capacity 1024, random int8 pools and
    bf16 scales: lengths mixed over 0..1024, one slot at capacity (its
    clipped write lands on a row the step reads) and one inactive slot (it
    appends nothing).  Both sides quantize and scatter the fresh rows with
    the same torch ops; the kernel reads the pools and writes none of them.
    f32 weights: hidden within 1e-4 (atol and rtol) after one layer of
    the plain version with the kernel's bf16 rounding of the v-scaled
    softmax weights that lie at a rounding midpoint within f32 error
    (``int8_aligned_layer``; a first-order flip bound only for weights it
    cannot align, counted), and INT8_F32_DEEP_TOL after all 12; bf16:
    within 3e-2 after one layer and BF16_DEEP_TOL after all 12 (after 12
    layers the plain version on the CPU against the plain version on the
    card is printed beside it).  Appended rows: scales within
    rtol 2e-2 after one layer and within the hidden's tolerance (relative)
    after 12, and dequantized values within the hidden's tolerance plus one quantization
    step (a scale one bf16 step apart moves a value near the absmax by two
    int8 steps); every other row, scale rows included, bit-identical."""
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import paged_allheads as pa

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    b, ps, pps = 32, 64, 16
    cap = ps * pps
    h_n, dh = config.net.num_heads, config.net.head_dim
    w = h_n * dh
    index = torch.tensor([0, 1, 63, 64, 1000, cap, 65, 127, 128, 500, 999, 2] * 3,
                         dtype=torch.int32, device=dev)[:b]
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[7] = False
    x = torch.randn((b, config.net.hidden_size), generator=gen, device=dev) * 0.1
    kw = dict(page_size=ps, pages_per_slot=pps)

    def appended(n_layers):
        """[n_pages, ps] mask of the rows the step appends: each ACTIVE slot
        of every layer at clip(index, 0, cap-1)."""
        wpos = index.clamp(0, cap - 1).long()
        slots = torch.arange(b, device=dev)[active]
        page = ((torch.arange(n_layers, device=dev)[:, None] * b + slots) * pps
                + wpos[slots] // ps).flatten()
        mask = torch.zeros((n_layers * b * pps, ps), dtype=torch.bool, device=dev)
        mask[page, (wpos[slots] % ps).repeat(n_layers)] = True
        return mask

    def err(a, b_):
        return float((a.float() - b_.float()).abs().max())

    n_all = config.net.num_layers * b * pps
    k0 = torch.randint(-127, 128, (n_all, ps, w), generator=gen, device=dev, dtype=torch.int8)
    v0 = torch.randint(-127, 128, (n_all, ps, w), generator=gen, device=dev, dtype=torch.int8)
    s0 = (torch.rand((n_all, ps, pa.LANE), generator=gen, device=dev) * 0.02
          + 1e-3).to(torch.bfloat16)
    errs, result = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_model(config, seed=1, dtype=dtype, device=dev)
        full = fs.prepare_fused(model.net)
        del model
        case = {}
        for n_layers in (1, config.net.num_layers):
            net = type(config.net)(**{**config.net.__dict__, "num_layers": n_layers})
            fused = fs.FusedWeights(*(t[:n_layers] for t in full[:5]), full.final_norm)
            n_pages = n_layers * b * pps
            kern = pa.PagedPools(k0[:n_pages].clone(), v0[:n_pages].clone(), s0[:n_pages].clone())
            plain = pa.PagedPools(k0[:n_pages].clone(), v0[:n_pages].clone(),
                                  s0[:n_pages].clone())
            h, _ = fs.fused_decode_step(fused, net, x, kern, index, active, **kw)
            h_r, _ = fs.fused_decode_step_reference(fused, net, x, plain, index, active, **kw)
            torch.cuda.synchronize()
            written = appended(n_layers)
            require(bool(torch.isfinite(h.float()).all()), f"int8 step {dtype}: non-finite")
            for ours, ref, before in ((kern.k, plain.k, k0), (kern.v, plain.v, v0),
                                      (kern.scales, plain.scales, s0)):
                before = before[:n_pages]
                require(torch.equal(ours[~written], before[~written])
                        and torch.equal(ref[~written], before[~written]),
                        f"int8 step {dtype}: a row outside the active slots' appends changed")
            deep = n_layers > 1
            tol = ((INT8_F32_DEEP_TOL if deep else 1e-4) if dtype == torch.float32
                   else BF16_DEEP_TOL if deep else 3e-2)
            # the scale rows' k and v lanes; lanes [2H:128] are zero on both sides
            sk, sr = (t[written][:, :2 * h_n].float() for t in (kern.scales, plain.scales))
            deq = []
            for j, (ours, ref) in enumerate(((kern.k, plain.k), (kern.v, plain.v))):
                sc = [t[:, j * h_n:(j + 1) * h_n, None] for t in (sk, sr)]
                a = ours[written].float().view(-1, h_n, dh) * sc[0]
                r = ref[written].float().view(-1, h_n, dh) * sc[1]
                deq.append(float(((a - r).abs() - torch.maximum(*sc)).max()))
            got = {"hidden": err(h, h_r), "scales_rel": float(((sk - sr).abs() / sr).max()),
                   "dequantized_minus_one_step": max(deq)}
            if deep:  # the same plain version on the CPU: its spread from summation order
                cpu = pa.PagedPools(*(t[:n_pages].cpu() for t in (k0, v0, s0)))
                h_c, _ = fs.fused_decode_step_reference(
                    fs.FusedWeights(*(t.cpu() for t in fused)), net, x.cpu(), cpu,
                    index.cpu(), active.cpu(), **kw)
                sc = cpu.scales[written.cpu()][:, :2 * h_n].float()
                got["plain_cpu_vs_plain_card"] = {
                    "hidden": err(h_c, h_r.cpu()),
                    "scales_rel": float(((sc - sr.cpu()).abs() / sr.cpu()).max())}
                del cpu
            if deep:
                close = got["hidden"] <= tol
            elif dtype == torch.float32:
                # within tol of the plain version, once the v-scaled weights
                # at a bf16 rounding midpoint take the kernel's rounding
                kq = int8_kernel_qkv(fused, net, x, pa.PagedPools(k0[:n_pages], v0[:n_pages],
                                                                  s0[:n_pages]),
                                     index, active, **kw)
                h_a, h_p, flips, got["weights_at_a_midpoint"], got["not_aligned"] = (
                    int8_aligned_layer(fused, net, x, pa.PagedPools(k0, v0, s0), index, active,
                                       kq, **kw))
                got["flip_bound_not_aligned"] = float(flips.max())
                got["hidden_vs_aligned"] = err(h, h_a)
                got["plain_replayed"] = err(h_p, h_r)
                # the replay is the plain version's own math: f32 rounding only
                require(torch.allclose(h_p, h_r.float(), atol=1e-5, rtol=1e-5),
                        f"int8 step f32: the plain layer replayed: {got}")
                close = bool(((h.float() - h_a).abs()
                              <= tol + tol * h_a.abs() + flips).all())
            else:
                close = bool(((h.float() - h_r.float()).abs()
                              <= tol + tol * h_r.float().abs()).all())
            # a scale is its fresh row's absmax / 127: after 12 layers the rows
            # drift as the hidden does
            require(close and got["scales_rel"] <= (tol if deep else 2e-2)
                    and got["dequantized_minus_one_step"] <= tol,
                    f"int8 step {dtype}, {n_layers} layers: {got}")
            case[f"{n_layers}_layers"] = got
            if dtype == torch.bfloat16 and n_layers == config.net.num_layers:
                weights = sum(t.numel() for t in fused[:5])
                cached = int(index.clamp(max=cap)[active].sum()) * n_layers
                n_live = int(active.sum()) * n_layers
                result = {"ms": time_ms(lambda: fs.fused_decode_step(
                              fused, net, x, kern, index, active, **kw), 20),
                          "plain_ms": time_ms(lambda: fs.fused_decode_step_reference(
                              fused, net, x, plain, index, active, **kw), 3),
                          "library_ms": None,
                          # bf16 weights; int8 rows and one k and one v bf16 scale
                          # per head; the appended rows and scale rows written
                          **bound(2 * weights + cached * (2 * w + 2 * h_n * 2)
                                  + n_live * (2 * w + 2 * pa.LANE),
                                  2 * b * weights + 4 * cached * w, "bf16")}
            del kern, plain
        errs[str(dtype)] = case
        del full
        torch.cuda.empty_cache()
    result["max_abs_err"] = errs["torch.float32"][f"{config.net.num_layers}_layers"]["hidden"]
    emit({"phase": "kernel", "name": "fused_step_int8", "batch": b, "index": index.tolist(),
          "inactive_slot": 7, "by_dtype": errs, **result, "card": card})
    return result


def check_attention_bwd(card: str, gen) -> dict:
    """The causal-attention backward kernel against its plain version
    (``causal_attention_backward_reference``) at the training shapes.  Both
    take the forward kernel's output (an input of the backward, held
    against the plain forward's by ``check_attention``; the plain forward's
    own output, a bf16 step away, moves D and so dq by up to 0.031 at Dh
    256, more than the backward's own tolerance), and each its own forward's
    log-sum-exp: the kernel the forward kernel's, the plain version the
    plain forward's (``_reference_with_lse``); the two LSEs agree within
    LSE_TOL.  The event net
    [2, 2047, 16, 64] (S = max_len - 1: a ragged last tile on both sides)
    and the token net [4094, 8, 4, 256], in f32 and bf16, plus GQA cases
    (16 query heads over 4 kv heads, f32 and bf16) with a strided q.  f32:
    dq, dk, dv within atol and rtol 1e-4 (summation order).  bf16: within
    2e-2 — both sides round P to bf16 at the same point for dv and sum in
    f32; the kernel also rounds dS to bf16 for its dq and dk products; both
    round the gradients to bf16: one bf16 step at magnitude 2-4.  The four
    training-shape cases are timed (:func:`time_attention_bwd`) beside one
    ``scaled_dot_product_attention`` backward on the same inputs (the
    summary line's ``library_ms``; timed only, used nowhere); the bf16 event
    net's also beside SDPA's forward + backward and with the forward kernel
    with and without its log-sum-exp output."""
    import torch

    dev = torch.device("cuda")
    # the GQA bf16 case draws from its own generator (see check_attention)
    added = torch.Generator(device=dev)
    added.manual_seed(4322)
    cases = [(2, 2047, 16, 16, 64, torch.float32, gen), (2, 2047, 16, 16, 64, torch.bfloat16, gen),
             (4094, 8, 4, 4, 256, torch.float32, gen), (4094, 8, 4, 4, 256, torch.bfloat16, gen),
             (2, 300, 16, 4, 64, torch.float32, gen), (2, 2047, 16, 4, 64, torch.bfloat16, added)]
    errs = {}
    for b, s, h, hkv, dh, dtype, g in cases:
        # the training shapes, timed
        timed = hkv == h and b * s * h * dh > 1 << 20
        errs[f"{dtype}[{b},{s},{h},{hkv},{dh}]"] = attention_bwd_case(
            b, s, h, hkv, dh, dtype, g, timed, full=timed and dtype == torch.bfloat16
            and dh == 64)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    result = {k: errs["torch.bfloat16[2,2047,16,16,64]"][k] for k in keys}
    result_f32 = {k: errs["torch.float32[2,2047,16,16,64]"][k] for k in keys}
    for res, kind in ((result, "bfloat16"), (result_f32, "float32")):
        res["max_abs_err"] = max(max(c[g] for g in ("dq", "dk", "dv"))
                                 for n, c in errs.items() if kind in n)
    emit({"phase": "kernel", "name": "causal_attention_bwd", "by_case": errs, **result,
          "f32": result_f32, "card": card})
    return {"causal_attention_bwd": result, "causal_attention_bwd_f32": result_f32}


def attention_bwd_case(b: int, s: int, h: int, hkv: int, dh: int, dtype, g, timed: bool,
                       full: bool = False) -> dict:
    """One case of :func:`check_attention_bwd` (its checks and, ``timed``,
    :func:`time_attention_bwd`'s readings); inputs drawn from ``g``."""
    import torch

    from midi_model_tpu_torch.ops import attention as at

    dev = torch.device("cuda")
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    name = f"{dtype}[{b},{s},{h},{hkv},{dh}]"
    wide = torch.randn((b, s, h, 2 * dh), generator=g, device=dev).to(dtype)
    q = wide[..., :dh]  # strided: no copy
    k = torch.randn((b, s, hkv, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, dh), generator=g, device=dev).to(dtype)
    dout = torch.randn((b, s, h, dh), generator=g, device=dev).to(dtype)
    out, lse = at._forward(q, k, v, with_lse=True)
    lse_r = at._reference_with_lse(q, k, v, at.causal_bias(s, dev))[1]
    grads = at.causal_attention_backward(q, k, v, out, dout, lse)
    ref = at.causal_attention_backward_reference(q, k, v, out, dout, lse_r)
    torch.cuda.synchronize()
    case = {"lse": float((lse - lse_r).abs().max())}
    require(torch.allclose(lse, lse_r, **LSE_TOL),
            f"attention backward {name}: the forward's LSE differs by {case['lse']}")
    del lse_r
    for g_name, ours, want in zip(("dq", "dk", "dv"), grads, ref):
        require(ours.shape == want.shape and bool(torch.isfinite(ours.float()).all()),
                f"attention backward {name}: {g_name} shape or non-finite")
        case[g_name] = float((ours.float() - want.float()).abs().max())
        require(torch.allclose(ours.float(), want.float(), **tol),
                f"attention backward {name}: {g_name} differs by {case[g_name]}")
    if timed:
        case.update(time_attention_bwd(q, k, v, out, dout, lse, full=full))
    del wide, q, k, v, dout, out, lse, grads, ref
    torch.cuda.empty_cache()
    return case


def time_attention_bwd(q, k, v, out, dout, lse, full: bool) -> dict:
    """The backward kernel's time beside its plain version's, its bound (at
    the rate of the route it runs) and one ``scaled_dot_product_attention``
    backward on a retained graph (SDPA's backward alone: ``library_ms``,
    timed here only).  ``full`` adds SDPA's forward + backward and forward
    alone and the forward kernel with and without its log-sum-exp."""
    import torch

    from midi_model_tpu_torch.ops import attention as at

    b, s, h, dh = q.shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    gt = dout.transpose(1, 2)
    graph = sdpa(qt, kt, vt, is_causal=True)

    def library_backward():  # SDPA's backward alone, on a retained graph
        torch.autograd.grad(graph, (qt, kt, vt), gt, retain_graph=True)

    pairs = b * h * s * (s + 1) // 2  # causal (query, key) pairs
    # q, k, v, out, dout read, dq, dk, dv written, lse read; five products
    # over the causal pairs (the recomputed scores, dv, dp, dq, dk)
    n_bytes = 8 * b * s * h * dh * q.element_size() + 4 * b * h * s
    n_ops = 5 * 2 * dh * pairs
    timed = {
        "ms": time_ms(lambda: at.causal_attention_backward(q, k, v, out, dout, lse), 5),
        "plain_ms": time_ms(lambda: at.causal_attention_backward_reference(
            q, k, v, out, dout, lse), 2),
        "library_ms": time_ms(library_backward, 10),
        **bound(n_bytes, n_ops, attention_route(q.dtype, dh))}
    if q.dtype == torch.float32:
        timed["bound_ffma_ms"] = bound(n_bytes, n_ops, "f32")["bound_ms"]
    if full:
        def library():
            o = sdpa(qt, kt, vt, is_causal=True)
            o.backward(gt)

        timed.update({
            "library_forward_backward_ms": time_ms(library, 10),
            "library_forward_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 10),
            "forward_ms": time_ms(lambda: at._forward(q, k, v, with_lse=False), 5),
            "forward_with_lse_ms": time_ms(lambda: at._forward(q, k, v, with_lse=True), 5)})
    del graph
    return timed


def check_event_loop(card: str, gen) -> dict:
    """The 8-event loop kernel at tv2o-medium, B=32, every slot at 1000
    cached rows of random K/V (capacity 1024, pages of 64), eos disabled.
    f32 against its plain version: rows identical (greedy and sampled),
    hidden and appended rows within 1e-4.  Rows outside the appends stay
    bit-identical.  bf16 against the per-event kernel pair on the same
    inputs (the same phases; the token net's input normed by torch between
    launches): greedy rows identical in at least 90% of the batch rows (a
    one-step bf16 difference may decide a near-tie; the checks of the token
    row say how often); the shares against the plain version are printed."""
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import event_loop as el
    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import paged_allheads as pa
    from midi_model_tpu_torch.ops import token_loop as tl
    from midi_model_tpu_torch.sampling import build_mask_table, gumbel_rows, mask_tensors

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    tok = config.tokenizer
    b, n_ev, ps, pps, len0 = 32, el.EVENTS_PER_LAUNCH, 64, 16, 1000
    t_max = tok.max_token_seq
    masks = mask_tensors(build_mask_table(tok, disable_eos=True), dev)
    hidden = torch.randn((b, config.n_embd), generator=gen, device=dev)
    w = config.net.num_heads * config.net.head_dim
    slots = config.net.num_layers * b
    n_pages = slots * pps
    kw = dict(n_events=n_ev, page_size=ps, pages_per_slot=pps)
    knobs = (masks, 1.0, 0.98, 20)
    # the appended rows: positions len0 .. len0 + n_ev - 1 of every slot and layer
    written = torch.zeros((n_pages, ps), dtype=torch.bool, device=dev)
    for pos in range(len0, len0 + n_ev):
        written[torch.arange(slots, device=dev) * pps + pos // ps, pos % ps] = True

    def err(a, b_):
        return float((a.float() - b_.float()).abs().max())

    def pair(model, fused, h, pools, g, greedy):
        """The per-event kernel pair: token row, event embedding, whole step."""
        rows = []
        for e in range(n_ev):
            row, _ = tl.decode_token_row(model, config, h, *knobs,
                                         None if greedy else g[e], greedy=greedy)
            index = torch.full((b,), len0 + e, dtype=torch.int32, device=dev)
            h, pools = fs.fused_decode_step(fused, config.net, el.event_embedding(model, row),
                                            pools, index, page_size=ps, pages_per_slot=pps)
            rows.append(row)
        return torch.stack(rows), h, pools

    def share(rows, ref):
        """Share of batch rows whose every event's row is identical."""
        return float((rows == ref).all(dim=2).all(dim=0).float().mean())

    out, result = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_model(config, seed=2, dtype=dtype, device=dev)
        fused = fs.prepare_fused(model.net)
        k0 = torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype)
        v0 = torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype)
        case = {}
        for greedy in (True, False):
            name = f"{dtype} {'greedy' if greedy else 'sampled'}"
            g = None if greedy else torch.stack([gumbel_rows(b, t_max, gen)
                                                 for _ in range(n_ev)])
            kern = pa.PagedPools(k0.clone(), v0.clone())
            plain = pa.PagedPools(k0.clone(), v0.clone())
            rows, h, _ = el.decode_event_block(model, config, fused, hidden, kern, len0,
                                               *knobs, g, greedy=greedy, **kw)
            rows_r, h_r, _ = el.decode_event_block_reference(
                model, config, fused, hidden, plain, len0, *knobs, g, greedy=greedy, **kw)
            torch.cuda.synchronize()
            for ours, ref, before in ((kern.k, plain.k, k0), (kern.v, plain.v, v0)):
                require(torch.equal(ours[~written], before[~written])
                        and torch.equal(ref[~written], before[~written]),
                        f"event loop {name}: a row outside the appends changed")
            require(bool(torch.isfinite(h.float()).all()), f"event loop {name}: non-finite")
            got = {"identical_row_share": share(rows, rows_r), "hidden": err(h, h_r),
                   "appended_rows": max(err(kern.k[written], plain.k[written]),
                                        err(kern.v[written], plain.v[written]))}
            del kern, plain
            if dtype == torch.float32:
                require(got["identical_row_share"] == 1.0
                        and got["hidden"] <= 1e-4 and got["appended_rows"] <= 1e-4,
                        f"event loop {name}: {got}")
            else:
                rows_p, h_p, _ = pair(model, fused, hidden,
                                      pa.PagedPools(k0.clone(), v0.clone()), g, greedy)
                torch.cuda.synchronize()
                got["vs_kernel_pair"] = {"identical_row_share": share(rows, rows_p),
                                         "hidden": err(h, h_p)}
                require(not greedy or got["vs_kernel_pair"]["identical_row_share"] >= 0.9,
                        f"event loop {name}: {got}")
            case["greedy" if greedy else "sampled"] = got
        out[str(dtype)] = case
        if dtype == torch.bfloat16:  # the main path's dtype and knobs
            g = torch.stack([gumbel_rows(b, t_max, gen) for _ in range(n_ev)])
            pools = pa.PagedPools(k0.clone(), v0.clone())  # each run rewrites the same rows
            result = {
                "ms": time_ms(lambda: el.decode_event_block(
                    model, config, fused, hidden, pools, len0, *knobs, g, greedy=False,
                    **kw), 10),
                "plain_ms": time_ms(lambda: el.decode_event_block_reference(
                    model, config, fused, hidden, pools, len0, *knobs, g, greedy=False,
                    **kw), 2),
                "kernel_pair_ms": time_ms(lambda: pair(model, fused, hidden, pools, g, False),
                                          10),
                "library_ms": None}
            ev_w = sum(t.numel() for t in fused[:5])
            cached = b * len0 * config.net.num_layers
            result.update(bound(
                2 * (ev_w + tok_net_params(model) + cached * 2 * w
                     + n_ev * b * config.net.num_layers * 2 * w),
                2 * n_ev * b * (ev_w + t_max * tok_net_params(model)) + 4 * n_ev * cached * w,
                "bf16"))
            del pools
        del model, fused, k0, v0
        torch.cuda.empty_cache()
    result["max_abs_err"] = max(c["hidden"] for c in out["torch.float32"].values())
    emit({"phase": "kernel", "name": "event_loop", "batch": b, "events": n_ev,
          "cached_rows": len0, "by_case": out, **result, "card": card})
    return result


def check_event_loop_ragged(card: str, gen) -> dict:
    """The ragged event loop (the batcher's merged path) at tv2o-medium,
    B=32, 8 events, pages of 64, capacity 2048, eos enabled: mixed lengths,
    one slot inactive at entry, one that reaches the capacity after 3
    events, per-slot temp / top_p / top_k, allow planes — ten slots may
    start a row only with eos or a note, at a high temperature, so slots
    draw eos mid-block.  f32 against its plain version: rows identical
    (greedy and sampled), hidden and appended rows within 1e-4, every other
    row untouched.  bf16 against the per-event composition of the kernels
    on the same inputs (token row with forced_pad = ~alive, event
    embedding, whole step with active = alive, hidden frozen for retired
    slots): rows and the hidden of the slots alive at the end
    bit-identical; the share of rows identical to the plain version is
    printed, with the logit gap of each greedy pick that differs from the
    plain version's at the first event (a near-tie)."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import event_loop as el
    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import paged_allheads as pa
    from midi_model_tpu_torch.ops import token_loop as tl
    from midi_model_tpu_torch.sampling import (build_allow_vector, build_mask_table,
                                               mask_tensors, slot_gumbel)

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    tok = config.tokenizer
    b, n_ev, ps, pps = 32, 8, 64, 32
    cap = ps * pps
    t_max = tok.max_token_seq
    eos, pad = tok.eos_id, tok.pad_id
    masks = mask_tensors(build_mask_table(tok), dev)
    rng = np.random.default_rng(3)
    index = torch.as_tensor(rng.integers(1, cap - 100, b), dtype=torch.int32, device=dev)
    index[3] = cap - 3  # retires at capacity after 3 events
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[5] = False
    eos_slots = list(range(8, 18))
    temp = torch.tensor([1.0, 0.8, 1.2, 1.0] * 8, device=dev)
    temp[eos_slots] = 1e3
    top_p = torch.tensor([0.98, 0.9, 1.0, 0.5] * 8, device=dev)
    top_k = torch.tensor([20, 8, 128, 64] * 8, dtype=torch.int32, device=dev)
    allow = np.ones((b, tok.vocab_size), bool)
    note_or_eos = np.ones(tok.vocab_size, bool)
    note_or_eos[[i for n, i in tok.event_ids.items() if n != "note"]] = False
    allow[eos_slots] = note_or_eos
    allow[0] = build_allow_vector(tok, disable_patch_change=True, disable_channels=[1, 3])
    allow[3, eos] = False  # slot 3 runs into the capacity
    allow = torch.as_tensor(allow, device=dev)
    seeds = torch.as_tensor(rng.integers(0, 2 ** 32, b), device=dev)
    noise = slot_gumbel(seeds, index[None, :] + torch.arange(n_ev, device=dev)[:, None], t_max)
    hidden = torch.randn((b, config.n_embd), generator=gen, device=dev)
    w = config.net.num_heads * config.net.head_dim
    n_pages = config.net.num_layers * b * pps
    kw = dict(n_events=n_ev, page_size=ps, pages_per_slot=pps)

    def written(rows):
        """[n_pages, ps] mask of the appended rows: slot s at index_s + e in
        every layer while it is alive (its row does not start with pad)."""
        mask = torch.zeros((n_pages, ps), dtype=torch.bool, device=dev)
        for e, s in (rows[:, :, 0] != pad).nonzero().tolist():
            pos = int(index[s]) + e
            pages = (torch.arange(config.net.num_layers, device=dev) * b + s) * pps + pos // ps
            mask[pages, pos % ps] = True
        return mask

    def composition(model, fused, pools, g, greedy):
        """The per-event kernels: token row, event embedding, whole step."""
        alive, h, rows = active.clone(), hidden.clone(), []
        for e in range(n_ev):
            row, _ = tl.decode_token_row(model, config, h, masks, temp, top_p, top_k,
                                         None if greedy else g[e], greedy=greedy,
                                         forced_pad=~alive, allow=allow)
            pos = index + e
            h_new, pools = fs.fused_decode_step(fused, config.net, el.event_embedding(model, row),
                                                pools, pos, alive, page_size=ps,
                                                pages_per_slot=pps)
            h = torch.where(alive[:, None], h_new, h.to(h_new.dtype))
            alive = alive & (row[:, 0] != eos) & (pos + 1 < cap)
            rows.append(row)
        return torch.stack(rows), h, alive

    def err(a, b_):
        return float((a.float() - b_.float()).abs().max())

    out, result = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_model(config, seed=4, dtype=dtype, device=dev)
        fused = fs.prepare_fused(model.net)
        k0 = torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype)
        v0 = torch.randn((n_pages, ps, w), generator=gen, device=dev).to(dtype)
        case = {}
        for greedy in (True, False):
            name = f"{dtype} {'greedy' if greedy else 'sampled'}"
            g = None if greedy else noise
            args = (model, config, fused, hidden)
            knobs = (index, active, masks, temp, top_p, top_k, g, allow)
            kern = pa.PagedPools(k0.clone(), v0.clone())
            rows, h, _ = el.decode_event_block_ragged(*args, kern, *knobs, greedy=greedy, **kw)
            plain = pa.PagedPools(k0.clone(), v0.clone())
            rows_r, h_r, _ = el.decode_event_block_ragged_reference(*args, plain, *knobs,
                                                                    greedy=greedy, **kw)
            torch.cuda.synchronize()
            alive_rows = rows[:, :, 0] != pad
            eos_at = (rows[:, :, 0] == eos).nonzero().tolist()
            require(bool((rows[:, 5] == pad).all()), f"ragged {name}: inactive slot not pad")
            require(bool(alive_rows[:3, 3].all() and not alive_rows[3:, 3].any()),
                    f"ragged {name}: slot 3 did not retire at capacity after 3 events")
            require(bool(torch.isfinite(h.float()).all()), f"ragged {name}: non-finite")
            got = {"eos_at_event_slot": eos_at,
                   "identical_row_share": float((rows == rows_r).all(dim=2).all(dim=0)
                                                .float().mean())}
            if dtype == torch.float32:
                mask = written(rows)
                for ours, ref, before in ((kern.k, plain.k, k0), (kern.v, plain.v, v0)):
                    require(torch.equal(ours[~mask], before[~mask])
                            and torch.equal(ref[~mask], before[~mask]),
                            f"ragged {name}: a row outside the appends changed")
                got.update(hidden=err(h, h_r),
                           appended_rows=max(err(kern.k[mask], plain.k[mask]),
                                             err(kern.v[mask], plain.v[mask])))
                require(torch.equal(rows, rows_r) and got["hidden"] <= 1e-4
                        and got["appended_rows"] <= 1e-4, f"ragged {name}: {got}")
                if not greedy:
                    require(any(e >= 1 for e, _ in eos_at),
                            f"ragged {name}: no slot drew eos mid-block: {eos_at}")
            else:
                rows_c, h_c, alive_end = composition(model, fused,
                                                     pa.PagedPools(k0.clone(), v0.clone()),
                                                     g, greedy)
                torch.cuda.synchronize()
                same_rows = torch.equal(rows, rows_c)
                same_hidden = torch.equal(h[alive_end], h_c[alive_end])
                if greedy:  # rows first differing from the plain version at event 0
                    got["event0_tie_logit_gaps"] = tie_gaps(model, hidden, rows[0], rows_r[0],
                                                            temp)
                got["vs_kernel_composition"] = {"rows_identical": same_rows,
                                                "alive_hidden_identical": same_hidden,
                                                "hidden": err(h[alive_end], h_c[alive_end])}
                require(same_rows and same_hidden, f"ragged {name}: {got}")
            del kern, plain
            case["greedy" if greedy else "sampled"] = got
        out[str(dtype)] = case
        if dtype == torch.bfloat16:  # the batcher's dtype
            pools = pa.PagedPools(k0.clone(), v0.clone())
            run = (lambda: el.decode_event_block_ragged(
                model, config, fused, hidden, pools, index, active, masks, temp, top_p,
                top_k, noise, allow, greedy=False, **kw))
            rows, _, _ = run()
            n_live = int((rows[:, :, 0] != pad).sum())  # alive (slot, event) pairs
            cached = int(index[active].long().sum()) * config.net.num_layers
            weights = sum(t.numel() for t in fused[:5]) + tok_net_params(model)
            n_bytes = 2 * (weights + cached * 2 * w + n_live * config.net.num_layers * 2 * w)
            n_ops = (2 * n_live * (sum(t.numel() for t in fused[:5])
                                   + t_max * tok_net_params(model))
                     + 4 * n_ev * cached * w)
            result = {
                "ms": time_ms(run, 5),
                "plain_ms": time_ms(lambda: el.decode_event_block_ragged_reference(
                    model, config, fused, hidden, pools, index, active, masks, temp, top_p,
                    top_k, noise, allow, greedy=False, **kw), 2),
                "composition_ms": time_ms(lambda: composition(model, fused, pools, noise,
                                                              False), 5),
                "library_ms": None, **bound(n_bytes, n_ops, "bf16")}
            del pools
        del model, fused, k0, v0
        torch.cuda.empty_cache()
    result["max_abs_err"] = max(c["hidden"] for c in out["torch.float32"].values())
    emit({"phase": "kernel", "name": "event_loop_ragged", "batch": b, "events": n_ev,
          "index": index.tolist(), "by_case": out, **result, "card": card})
    return result


def tok_net_params(model) -> int:
    """Weights the token row reads: the token net's layers, its final norm
    and the shared lm_head."""
    return (sum(p.numel() for p in model.net_token.layers.parameters())
            + model.net_token.norm.weight.numel() + model.lm_head.weight.numel())


# H100 SXM, dense, per second; "3xtf32": an f32 product as three TF32
# tensor-core products (hi.hi + hi.lo + lo.hi), a third of the TF32 rate
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "3xtf32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12


def attention_route(dtype, dh: int) -> str:
    """The rate the causal attention kernels' products run at: bf16 tensor
    cores; f32 at head_dim 64 as 3xTF32 on the tensor cores; f32 at 256 on
    the CUDA cores."""
    import torch

    if dtype == torch.bfloat16:
        return "bf16"
    return "3xtf32" if dh == 64 else "f32"


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_oracle(card: str):
    import numpy as np
    import torch

    from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.sampling import generate

    golden = pickle.loads((ROOT / "tests/golden/reference_oracle.pkl").read_bytes())
    config = MIDIModelConfig.from_name(golden["config"])
    sd = synthesize_state_dict(golden["layout"], golden["seed"])
    model = params_from_state_dict(sd, config, dtype=torch.float32,
                                   device=torch.device("cuda"))
    del sd
    _build.LAUNCHES.clear()
    prompt = torch.as_tensor(golden["prompt"], device="cuda")
    with torch.no_grad():
        hidden, _ = model(prompt)
        logits, _ = model.forward_token(hidden[:, -1], None)
    logits = logits.cpu().numpy()
    ref_logits = golden["logits"].reshape(logits.shape)
    err = float(np.abs(logits - ref_logits).max())
    require(np.allclose(logits, ref_logits, **LOGITS_TOL), f"oracle logits (max err {err})")
    ref = golden["greedy"]
    rows = generate(model, config, prompt=golden["prompt"][0], batch_size=ref.shape[0],
                    max_len=ref.shape[1], greedy=True)
    same = rows.shape == ref.shape and bool((rows == ref).all())
    require(same, "oracle greedy rows differ from the golden")
    counts = dict(_build.LAUNCHES)
    require(counts.get("paged_decode", 0) > 0 and counts.get("causal_attention", 0) > 0,
            f"oracle run did not launch the kernels: {counts}")
    emit({"phase": "oracle", "config": golden["config"], "logits_max_abs_err": err,
          "greedy_shape": list(rows.shape), "greedy_identical": same,
          "launches": counts, "card": card})
    del model
    torch.cuda.empty_cache()


# the paged decode kernels as the profiler names them (csrc/paged_decode*.cu)
PAGED_KERNEL_NAMES = ("paged_decode",)


def device_profile(run, n_events: int) -> dict:
    """torch.profiler over ``run()`` (decoding ``n_events``): device kernel
    launches (every kernel on the card, not only ours), device time and wall
    time per event, the device's busy share, the top kernels, and the paged
    decode kernels' device ms and launches per event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    device_us = sum(t for _, t, _ in kernels)
    paged = [(t, c) for k, t, c in kernels if any(n in k for n in PAGED_KERNEL_NAMES)]
    return {"launches_per_event": sum(c for _, _, c in kernels) / n_events,
            "paged_ms_per_event": sum(t for t, _ in paged) / n_events / 1e3,
            "paged_launches_per_event": sum(c for _, c in paged) / n_events,
            "device_ms_per_event": device_us / n_events / 1e3,
            "wall_ms_per_event": wall_us / n_events / 1e3,
            "device_busy_share": device_us / wall_us,
            "top_kernels_ms_per_event": [(k[:50], t / n_events / 1e3)
                                         for k, t, _ in kernels[:5]]}


def phase_slice(card: str) -> dict:
    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.ops import event_loop as el
    from midi_model_tpu_torch.sampling import (build_mask_table, decode_events,
                                               generate, mask_tensors,
                                               normalize_prompt, prefill)

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    tokenizer = config.tokenizer
    model = init_model(config, seed=0, dtype=torch.bfloat16, device=dev)
    table = build_mask_table(tokenizer)
    batch = 32

    # the main path, once per decode path, each with the launch counts read
    # from exactly its own run: the default (fused at bf16: 259 events = 32
    # event-loop launches and a 3-event per-event tail), the split path, then
    # generate(kv_int8=True) by default (the per-event pair: the token row
    # and the whole step's int8 form, every event) and on the split path
    split_kernels = {"sampler", "paged_decode", "paged_decode_int8", "paged_decode_stream"}
    launches = {}
    for fused, kv_int8, max_len, kernels, never in (
            (None, False, 260, ("event_loop", "token_row", "fused_step", "causal_attention"),
             split_kernels),
            (False, False, 260, ("sampler", "paged_decode", "paged_decode_stream",
                                 "causal_attention"), {"token_row", "fused_step"}),
            (None, True, 40, ("token_row", "fused_step_int8", "causal_attention"),
             split_kernels | {"event_loop", "fused_step"}),
            (False, True, 40, ("sampler", "paged_decode_int8", "causal_attention"),
             {"paged_decode", "token_row", "fused_step", "fused_step_int8"})):
        _build.LAUNCHES.clear()
        rows = generate(model, config, batch_size=batch, max_len=max_len, temp=1.0,
                        top_p=0.98, top_k=20, seed=0, fused=fused, kv_int8=kv_int8)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        path = ("fused (default)" if fused is None else "split") + (
            ", int8 pools" if kv_int8 else "")
        require(rows.shape[0] == batch and 1 < rows.shape[1] <= max_len, f"rows {rows.shape}")
        check_rows(rows[:, 1:], table, tokenizer, f"generate bs=32, {path} path")
        for name in kernels:
            require(counts.get(name, 0) > 0, f"{path} path never launched {name}: {counts}")
        require(not set(counts) & never, f"the {path} path ran {set(counts) & never}: {counts}")
        if fused is None and kv_int8:  # one token row and one int8 whole step per event
            require(counts["token_row"] == counts["fused_step_int8"] == rows.shape[1] - 1,
                    f"int8 pair launches {counts} over {rows.shape[1] - 1} events")
        launches = {**counts, **launches}
        emit({"phase": "slice_generate", "path": path, "batch": batch,
              "rows_shape": list(rows.shape), "launches": counts, "card": card})

    # bench.py-shaped timed run: prefill + 256 events, eos disabled, the
    # paths below in turns: the fused ones twice, the host-bound split ones
    # (~16 s a run) once
    n_events = 256
    prompt = normalize_prompt(tokenizer, None, batch)
    table_ne = build_mask_table(tokenizer, disable_eos=True)
    masks = mask_tensors(table_ne, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)

    # per_event: the fused path with one token-row and one whole-step launch
    # per event (blocks of one event: no event-loop launch); the int8 pools'
    # per-event pair (their default) and split path
    paths = {"event_loop": (True, el.EVENTS_PER_LAUNCH, False),
             "per_event": (True, 1, False), "split": (False, el.EVENTS_PER_LAUNCH, False),
             "int8_pair": (True, el.EVENTS_PER_LAUNCH, True),
             "int8_split": (False, el.EVENTS_PER_LAUNCH, True)}

    def run(n, path, state=None):
        fused, el.EVENTS_PER_LAUNCH, kv_int8 = paths[path]
        if state is None:
            state = prefill(model, config, prompt, 1 + n_events, kv_int8=kv_int8)
        return decode_events(model, config, state, masks, n, 1.0, 0.98, 20, gen,
                             fused=fused)

    timed = {path: [] for path in paths}
    per_event = {}
    for path in paths:
        run(8, path)  # warm-up
    for path in list(paths) + [path for path, (fused, _, _) in paths.items() if fused]:
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        state, rows_t, n_done = run(n_events, path)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(n_done == n_events, f"timed run decoded {n_done} of {n_events}")
        check_rows(rows_t.cpu().numpy(), table_ne, tokenizer, f"timed run, {path} path")
        timed[path].append(batch * n_events / dt)
        per_event[path] = {k: c / n_events for k, c in _build.LAUNCHES.items()}
    profiles = {}
    for path in paths:
        state, _, _ = run(64, path)  # a mid-length cache
        torch.cuda.synchronize()
        profiles[path] = device_profile(lambda: run(16, path, state), 16)
        del state
    el.EVENTS_PER_LAUNCH = paths["event_loop"][1]
    emit({"phase": "slice_timed", "batch": batch, "events": n_events,
          "events_per_s": timed, "our_kernel_launches_per_event": per_event,
          "profile_16_events_after_64": profiles, "card": card})

    # long prompt: random 1024-event prompt, prefill timed, then 32 more events
    p_len = 1024
    rng = np.random.default_rng(0)
    long_prompt = rng.integers(3, tokenizer.vocab_size, (batch, p_len, 8))
    prefill(model, config, long_prompt, p_len + 32)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = prefill(model, config, long_prompt, p_len + 32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    require(bool(torch.isfinite(state.hidden.float()).all()), "long prefill hidden")
    del state
    prefill_ms = float(np.median(times)) * 1e3
    out = generate(model, config, prompt=long_prompt, batch_size=batch,
                   max_len=p_len + 32, seed=1)
    require(out.shape[1] > p_len and (out[:, :p_len] == long_prompt).all(),
            f"long-prompt generate {out.shape}")
    check_rows(out[:, p_len:], table, tokenizer, "long-prompt generate")
    emit({"phase": "slice_long_prompt", "batch": batch, "prompt_events": p_len,
          "prefill_ms_median_of_3": prefill_ms, "prefill_ms_runs": [t * 1e3 for t in times],
          "generated_events": out.shape[1] - p_len, "card": card})
    return launches


BANNED_CHANNELS = [2, 9]  # every fifth queued request bans them


def random_prompt(tok, rng, n: int):
    """A random ``[n, T]`` prompt from ``rng``, bos first."""
    rows = rng.integers(3, tok.vocab_size, (n, tok.max_token_seq))
    rows[0] = tok.pad_id
    rows[0, 0] = tok.bos_id
    return rows


def request_queue(tok, rng, n: int, prompts: tuple, budgets: tuple) -> list:
    """``n`` requests (prompt rows, budget, submit keywords) drawn from
    ``rng``: prompt lengths and budgets from ``prompts`` / ``budgets``
    (half-open); every fourth request with its own temp / top_p / top_k,
    every fifth with BANNED_CHANNELS."""
    out = []
    for i in range(n):
        extra = {}
        if i % 4 == 1:
            extra.update(temp=0.9, top_p=0.9, top_k=8)
        if i % 5 == 2:
            extra.update(disable_channels=BANNED_CHANNELS)
        out.append((random_prompt(tok, rng, int(rng.integers(*prompts))),
                    int(rng.integers(*budgets)), extra))
    return out


def check_queue(records, requests, tok, disable_eos: bool, what: str) -> None:
    """Each request's (rows, reason) in ``records`` ended on eos or decoded
    its budget, obeys the grammar and its bans."""
    from midi_model_tpu_torch.sampling import build_mask_table

    table = build_mask_table(tok, disable_eos=disable_eos)
    chan = {tok.vocab.param_base("channel") + c for c in BANNED_CHANNELS}
    for i, ((rows, reason), (_, budget, extra)) in enumerate(zip(records, requests)):
        require(len(rows) <= budget and (reason == "eos" or len(rows) == budget),
                f"{what} request {i}: {len(rows)} rows of {budget}, reason {reason}")
        if len(rows):
            check_rows(rows[None], table, tok, f"{what} request {i}")
            if "disable_channels" in extra:
                require(not set(rows.ravel().tolist()) & chan, f"{what} request {i}: a ban")


def phase_batcher(card: str, kv_int8: bool, fused=None):
    """The continuous batcher at tv2o-medium's full width, bf16 weights:
    32 slots, max_seq 2048, chunk 16, a queue of requests with prompts of
    16-1024 events and budgets of 64-512 events admitted as slots free up,
    some with their own temp / top_p / top_k, some with banned channels.
    bf16 pools run the ragged event loop (one launch per chunk); ``kv_int8``
    by default the per-event pair (token-row kernel, the whole step's int8
    form), with ``fused=False`` the split scan (token-row kernel, streaming
    int8 paged kernel).  The
    queue runs twice: with eos enabled (random weights end a request on eos
    after a few events, so that run is mostly admissions), then with eos
    disabled, every request decoding its whole budget (budget retirement,
    long co-tenancy, many chunks).  Every request finishes with grammatical
    rows free of its bans; events/s, the chunk count, chunk latency and
    prefill ms per admission group are printed for each run, and events/s
    and the device-busy share of a profiled window at full occupancy (eos
    disabled, every slot decoding).  bf16 also resubmits one seeded request
    into another slot beside other requests: its rows must be identical."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.serve import ContinuousBatcher

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    tok = config.tokenizer
    model = init_model(config, seed=5, dtype=torch.bfloat16, device=dev)
    kw = dict(n_slots=32, max_seq=2048, chunk=16, kv_int8=kv_int8, seed=11, fused=fused)
    path = "split" if fused is False else "pair" if kv_int8 else "event_loop"
    rng = np.random.default_rng(21 if kv_int8 else 20)
    n_req = 48 if kv_int8 else 64
    requests = request_queue(tok, rng, n_req, (16, 1025), (64, 513))

    def run_queue(disable_eos: bool) -> dict:
        """The whole queue through one batcher; its metrics and launches."""
        batcher = ContinuousBatcher(model, config, disable_eos=disable_eos, **kw)
        require(batcher.path == path and batcher.pipeline,
                f"batcher path: {batcher.path}, pipeline={batcher.pipeline}")
        groups = []  # (size, bucket, start event, stop event) of each admission forward
        prefill_group = batcher._prefill_group

        def timed_prefill(bucket, part):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            prefill_group(bucket, part)
            stop.record()
            groups.append((len(part), bucket, start, stop))

        batcher._prefill_group = timed_prefill
        dispatch = batcher._dispatch
        dispatched = []  # chunks sent to the card

        def counted_dispatch():
            dispatched.append(1)
            return dispatch()

        batcher._dispatch = counted_dispatch
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rids = [batcher.submit(p, budget, **extra) for p, budget, extra in requests]
        torch.cuda.synchronize()
        submit_s = time.perf_counter() - t0  # the first 32 admitted
        results, chunk_s = {}, []
        while batcher.any_active:
            ts = time.perf_counter()
            results.update((f.request_id, f) for f in batcher.step())
            chunk_s.append(time.perf_counter() - ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        require(set(results) == set(rids),
                f"batcher: {len(rids) - len(results)} requests unfinished")
        check_queue([(results[r].rows, results[r].reason) for r in rids], requests, tok,
                    disable_eos, "batcher")
        events = sum(len(results[r].rows) + (results[r].reason == "eos") for r in rids)
        n_chunks = len(dispatched)
        if path == "pair":
            require(counts.get("token_row", 0) > 0
                    and counts.get("token_row") == counts.get("fused_step_int8")
                    and not {"event_loop_ragged", "paged_decode_stream",
                             "paged_decode_int8", "fused_step"} & set(counts),
                    f"int8 batcher (pair) launches: {counts}")
        elif path == "split":
            require(counts.get("token_row", 0) > 0 and counts.get("paged_decode_stream", 0) > 0
                    and not {"event_loop_ragged", "paged_decode_int8",
                             "fused_step_int8"} & set(counts),
                    f"int8 batcher (split) launches: {counts}")
        else:
            require(counts.get("event_loop_ragged", 0) == n_chunks and "token_row" not in counts
                    and "paged_decode_stream" not in counts and "fused_step" not in counts,
                    f"bf16 batcher launches: {counts} over {n_chunks} chunks")
        prefill_ms = [(size, bucket, start.elapsed_time(stop))
                      for size, bucket, start, stop in groups]
        chunk_ms = sorted(t * 1e3 for t in chunk_s)
        return {
            "requests": n_req, "events": events, "wall_s": wall, "submit_s": submit_s,
            "events_per_s": events / wall,
            # the p99 of `steps` step() calls: the chunks dispatched, and the
            # pipeline's last call, which only reads
            "chunks": n_chunks, "steps": len(chunk_s),
            "chunk_ms_mean": float(np.mean(chunk_ms)),
            "chunk_ms_p99": float(np.percentile(chunk_ms, 99)),
            "chunk_ms_max": chunk_ms[-1],
            "prefill_groups": len(prefill_ms),
            "prefill_ms_per_group_mean": float(np.mean([t for _, _, t in prefill_ms])),
            "prefill_ms_by_size_bucket": prefill_ms[:12],
            "finish_reasons": {r: sum(f.reason == r for f in results.values())
                               for r in ("eos", "budget")},
            "launches": counts}

    metrics = {"eos_churn": run_queue(disable_eos=False),
               "budget_churn": run_queue(disable_eos=True)}
    require(metrics["budget_churn"]["finish_reasons"]["budget"] == n_req,
            f"budget churn: {metrics['budget_churn']['finish_reasons']}")
    counts = metrics["budget_churn"]["launches"]

    # full occupancy: 32 requests with eos disabled and budgets past the
    # window: 4 chunks timed after two, then 2 more profiled (every slot decodes)
    steady = ContinuousBatcher(model, config, disable_eos=True, **kw)
    for _ in range(32):
        steady.submit(random_prompt(tok, rng, int(rng.integers(16, 1025))), 512)
    for _ in range(2):
        steady.step()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(4):  # timed without the profiler, whose host tracing slows launches
        require(not steady.step(), "steady window: a request finished")
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - tw
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        for _ in range(2):
            require(not steady.step(), "steady window: a request finished")
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - tp
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    metrics["full_occupancy"] = {
        "slots": 32, "chunks": 4, "events_per_s": 32 * kw["chunk"] * 4 / wall_w,
        "chunk_ms": wall_w * 1e3 / 4, "profiled_chunks": 2,
        "device_ms_per_chunk": dev_us / 2e3, "profiled_chunk_ms": wall_p * 1e3 / 2,
        "device_busy_share": dev_us / 1e6 / wall_p,
        "device_share_of_unprofiled_chunk": dev_us / 2e3 / (wall_w * 1e3 / 4)}
    del steady

    if not kv_int8:  # one seeded request, alone in its prompt bucket, in two batches
        solo = random_prompt(tok, rng, 10)
        others = [(random_prompt(tok, rng, int(rng.integers(40, 300))), 96, {})
                  for _ in range(6)]
        runs = []
        for before in (0, 5):  # eos disabled: the request decodes its whole budget
            b2 = ContinuousBatcher(model, config, disable_eos=True, **kw)
            for p, budget, extra in others[:before]:
                b2.submit(p, budget, **extra)
            rid = b2.submit(solo, 48, seed=1234, temp=1.1)
            slot = next(i for i, sl in enumerate(b2.slots) if sl.request_id == rid)
            for p, budget, extra in others[before:]:
                b2.submit(p, budget, **extra)
            runs.append((slot, b2.run_all()[rid].rows))
        (slot_a, rows_a), (slot_b, rows_b) = runs
        same = rows_a.shape == rows_b.shape and bool((rows_a == rows_b).all())
        first_diff = None
        if not same:
            n = min(len(rows_a), len(rows_b))
            diff = np.nonzero((rows_a[:n] != rows_b[:n]).any(axis=1))[0]
            first_diff = int(diff[0]) if len(diff) else n
        metrics["seeded_resubmit"] = {"slots": [slot_a, slot_b], "rows": len(rows_a),
                                      "identical": same, "first_differing_event": first_diff}
        require(slot_a != slot_b and same and len(rows_a) == 48,
                f"seeded resubmit: {metrics['seeded_resubmit']}")
    emit({"phase": f"batcher_int8_{path}" if kv_int8 else "batcher_bf16", **metrics,
          "card": card})
    del model
    torch.cuda.empty_cache()
    return counts, metrics["full_occupancy"]["events_per_s"]


# the attention kernels' names as the profiler shows them (every form: the
# bf16 and f32 tensor-core kernels at head_dim 64, the row kernels of both
# dtypes at 256)
ATTENTION_FWD_KERNELS = ("fwd_wgmma_kernel", "fwd_tf32_kernel", "fwd_rows256_kernel")
ATTENTION_BWD_KERNELS = ("delta_kernel", "dkdv_tc_kernel", "dq_tc_kernel", "dkdv_rows256_kernel",
                         "dq_rows256_kernel", "dkdv_tf32_kernel", "dq_tf32_kernel")


# bf16 training step 0 through the attention kernels against the same step
# through plain attention under autograd (bs 1, 512 events): the two round
# at other points (the kernels' P unnormalized and dS to bf16, the plain
# version's normalized P), and every bf16 rounding flip downstream of an
# attention output moves the loss and the gradients by bf16 steps.
# Readings on an H100 (PERF.md section 6): loss 1.94e-5 relative, sampled
# gradients 6.2e-3 of each leaf's largest (the same with the parent's and
# this tree's bf16 kernels); plain bf16 against plain f32 in the same step
# 1.9e-2.  The bounds are about 2.5x the readings, and the gradients' stays
# below the bf16-vs-f32 spread: a kernel off by as much as bf16 itself fails.
BF16_STEP0_LOSS_RTOL = 5e-5
BF16_STEP0_GRAD_TOL = 1.5e-2


def training_corpus():
    """(config, work dir, batch_of): a corpus written from
    ``tests/golden/codec.pkl`` under ``build/`` (gitignored) and
    ``batch_of(n, max_len, seed)``, n collated sequences of it."""
    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.train import MidiDataset, find_midi_files

    config = MIDIModelConfig.from_name("tv2o-medium")
    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    corpus = work / "corpus"
    corpus.mkdir(parents=True)
    goldens = pickle.loads((ROOT / "tests/golden/codec.pkl").read_bytes())
    for name, g in goldens.items():
        if not name.startswith("bad_"):
            (corpus / f"{name}.mid").write_bytes(g["bytes"])
    files = find_midi_files(str(corpus))

    def batch_of(n, max_len, seed):
        ds = MidiDataset(files, config.tokenizer, max_len=max_len, aug=False,
                         rand_start=False, seed=seed)
        return ds.collate([ds[i] for i in range(n)], pad_to=max_len)

    return config, work, batch_of


def check_train_step0(card: str, config, batch_of) -> None:
    """Step 0 on one microbatch (bs 1, 512 events): the loss and a sample of
    gradients through the attention kernels (forward with its log-sum-exp,
    backward) against the same step with the plain attention
    (``attention_reference`` under torch's autograd).  f32: loss within rtol
    1e-5, each sampled gradient within 1e-4 of its largest value (f32 sums
    in another order over 511 rows and 15 layers).  bf16 compute: within
    BF16_STEP0_LOSS_RTOL and BF16_STEP0_GRAD_TOL; plain bf16 against plain
    f32 is printed beside it, the scale of bf16 rounding in this step."""
    import torch

    from midi_model_tpu_torch.models import llama
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.ops import attention as at
    from midi_model_tpu_torch.train import trainer as tr

    dev = torch.device("cuda")
    n_layers = config.net.num_layers + config.net_token.num_layers
    params = tr.init_params(config, seed=3, device=dev)
    mb = torch.as_tensor(batch_of(1, 512, 0), device=dev)
    sample = ["net.layers.0.self_attn.q_proj.weight", "net.layers.11.self_attn.k_proj.weight",
              "net.layers.5.mlp.down_proj.weight", "net_token.layers.0.self_attn.v_proj.weight",
              "net.embed_tokens.weight", "lm_head.weight"]

    def step0(dtype):
        p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
        loss, _ = tr.loss_fn(p, config, mb, compute_dtype=dtype)
        loss.backward()
        return float(loss.detach()), {n: p[n].grad for n in sample}

    def errors(a, b):  # loss relative error, gradients relative to each leaf's largest
        return (abs(a[0] - b[0]) / abs(b[0]),
                {n: float((a[1][n] - b[1][n]).abs().max() / b[1][n].abs().max())
                 for n in sample})

    result, runs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        _build.LAUNCHES.clear()
        kernel = step0(dtype)
        kernel_counts = dict(_build.LAUNCHES)
        kernel_attention = llama.causal_attention
        llama.causal_attention = lambda q, k, v: at.attention_reference(
            q, k, v, at.causal_bias(q.shape[1], q.device))
        try:
            _build.LAUNCHES.clear()
            plain = step0(dtype)
            plain_counts = dict(_build.LAUNCHES)
        finally:
            llama.causal_attention = kernel_attention
        torch.cuda.synchronize()
        require(kernel_counts.get("causal_attention_bwd") == n_layers and not plain_counts,
                f"step 0 {dtype}: launches: kernel path {kernel_counts}, plain path "
                f"{plain_counts}")
        loss_err, grad_err = errors(kernel, plain)
        runs[dtype] = plain
        result[str(dtype)] = {"loss_kernel": kernel[0], "loss_plain": plain[0],
                              "loss_rel_err": loss_err, "grad_err_rel_to_leaf_max": grad_err}
    loss_scale, grad_scale = errors(runs[torch.bfloat16], runs[torch.float32])
    result["plain_bf16_vs_plain_f32"] = {"loss_rel_err": loss_scale,
                                         "grad_err_rel_to_leaf_max": grad_scale}
    emit({"phase": "train_step0", "config": "tv2o-medium", "bs": 1, "events": 512,
          **result, "card": card})
    f32, bf16 = result[str(torch.float32)], result[str(torch.bfloat16)]
    require(f32["loss_rel_err"] <= 1e-5 and max(f32["grad_err_rel_to_leaf_max"].values()) <= 1e-4,
            f"step 0 f32: {f32}")
    require(bf16["loss_rel_err"] <= BF16_STEP0_LOSS_RTOL
            and max(bf16["grad_err_rel_to_leaf_max"].values()) <= BF16_STEP0_GRAD_TOL,
            f"step 0 bf16: {bf16}")
    del params, runs
    torch.cuda.empty_cache()


def timed_training(card: str, config, batch_of, compute_dtype, steps: int = 10,
                   remat=False, lora_rank: int = 0, lr: float = 3e-4,
                   phase: str = "train_timed") -> dict:
    """``steps`` optimizer steps at the CLI's shape (bs 2 x acc 2 x 2048
    events) on one fixed batch, f32 masters, ``compute_dtype`` compute,
    ``remat`` the recompute policy; with ``lora_rank`` the LoRA step (rank
    ``lora_rank``, alpha twice the rank, the CLI's ratio) on frozen random
    weights: the loss falls; ms per step (mean of steps 3 on), training
    tokens/s, peak device memory and the kernels' launches over the steps;
    then one step under ``torch.profiler``: device time by kernel, the
    attention kernels' share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from midi_model_tpu_torch.models.lora import init_lora
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.train import trainer as tr

    dev = torch.device("cuda")
    batch = batch_of(4, 2048, 1).reshape(2, 2, 2048, -1)
    opt = tr.make_optimizer(lr=lr, warmup_steps=0, total_steps=1000)
    params = tr.init_params(config, seed=4, device=dev)
    if lora_rank:
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        lora_step = tr.make_lora_train_step(config, opt, lora_alpha=2.0 * lora_rank,
                                            accum_steps=2, compute_dtype=compute_dtype,
                                            remat=remat)
        state = tr.init_train_state(init_lora(params, gen, rank=lora_rank), opt)

        def step(state, batch):
            return lora_step(state, params, batch)
    else:
        step = tr.make_train_step(config, opt, accum_steps=2, compute_dtype=compute_dtype,
                                  remat=remat)
        state = tr.init_train_state(params, opt)
        del params
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    _build.LAUNCHES.clear()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"fixed batch ({compute_dtype}, remat {remat!r}, lora rank {lora_rank}): the "
            f"loss did not fall: {losses}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(t for _, t in kernels)

    def time_of(names):
        return sum(t for k, t in kernels if any(x in k for x in names))

    bwd_us = time_of(ATTENTION_BWD_KERNELS)
    fwd_us = time_of(ATTENTION_FWD_KERNELS)
    fwd_by_kernel = {x: time_of((x,)) / 1e3 for x in ATTENTION_FWD_KERNELS}
    bwd_by_kernel = {x: time_of((x,)) / 1e3 for x in ATTENTION_BWD_KERNELS}
    require(fwd_us > 0 and bwd_us > 0, f"profiled step: no attention kernel time (forward "
            f"{fwd_us} us, backward {bwd_us} us): kernel names {[k for k, _ in kernels]}")
    step_ms = float(np.mean(times[2:])) * 1e3
    tokens = int(np.prod(batch.shape))  # microbatches x B x events x 8 tokens
    result = {
        "compute": f"{str(compute_dtype).split('.')[-1]}, f32 master", "remat": remat,
        "lora_rank": lora_rank,
        "fixed_batch_losses": losses, "ms_per_step": step_ms,
        "ms_per_step_runs": [t * 1e3 for t in times],
        "train_tokens_per_s": tokens / step_ms * 1e3, "peak_memory_gb": peak_gb,
        "launches": launches,
        "profiled_step": {"wall_ms": profiled_ms, "device_ms": device_us / 1e3,
                          "device_busy_share": device_us / 1e3 / profiled_ms,
                          "attention_bwd_ms": bwd_us / 1e3,
                          "attention_fwd_ms": fwd_us / 1e3,
                          "attention_bwd_share": bwd_us / device_us,
                          "attention_fwd_share": fwd_us / device_us,
                          "attention_fwd_ms_by_kernel": fwd_by_kernel,
                          "attention_bwd_ms_by_kernel": bwd_by_kernel,
                          "top_kernels_ms": sorted(((k[:60], t / 1e3) for k, t in kernels),
                                                   key=lambda kt: -kt[1])[:8]}}
    emit({"phase": phase, "config": "tv2o-medium", **result, "card": card})
    del state, step
    torch.cuda.empty_cache()
    return result


def train_cli_argv(work: Path, out: Path, steps: int) -> list:
    """Phase 6's CLI arguments: tv2o-medium on the smoke's corpus, bf16
    compute, bs 2 x acc 2 x 2048 events, ``steps`` steps and one validation
    (with its checkpoint and export) at the last."""
    return ["--data", str(work / "corpus"), "--config", "tv2o-medium", "--data-val-split", "2",
            "--max-len", "2048", "--batch-size-train", "2", "--acc-grad", "2",
            "--batch-size-val", "2", "--max-step", str(steps), "--val-step", str(steps),
            "--warmup-step", "2", "--workers-train", "2", "--batch-size-gen-example", "2",
            "--out-dir", str(out)]


def phase_train(card: str, corpus) -> dict:
    """Training at tv2o-medium's full width on a corpus written from
    ``tests/golden/codec.pkl`` (under ``build/``, gitignored):

    - step 0 through the kernels against plain attention, in f32 and in
      bf16 compute (:func:`check_train_step0`);
    - ``train.cli.main``: bf16 compute with f32 master weights,
      ``--batch-size-train 2 --acc-grad 2 --max-len 2048``, 5 optimizer
      steps, one validation, one checkpoint, the best-val export and the
      example pieces; the backward kernel launched (12 + 3 layers) x 2
      microbatches x 5 steps times, counted from the run; every logged loss
      finite; ``model.safetensors`` read back by the port's reader equals
      the final weights; then ``--resume`` takes one more step from the
      checkpoint (step 5 -> 6);
    - the timed loop (:func:`timed_training`) in bf16 compute, then in f32
      compute (the ``--fp32`` path: the f32 attention kernels).

    Returns the launches of the attention kernels: the bf16 ones from the
    CLI run, the f32 ones from the f32 timed loop.  The CLI's run directory
    stays for phase 7."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.interop import load_state_dict
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.train import cli

    config, work, batch_of = corpus
    n_layers = config.net.num_layers + config.net_token.num_layers
    check_train_step0(card, config, batch_of)

    # -- the CLI: 5 steps, validation, checkpoint, export, examples; then resume
    out = work / "run"
    argv = train_cli_argv(work, out, 5)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    state = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    logs = [json.loads(line) for line in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    cli_losses = [r["train/loss"] for r in logs if "train/loss" in r]
    val = [r for r in logs if "val/loss" in r]
    require(state.step == 5 and len(cli_losses) == 5 and all(np.isfinite(cli_losses))
            and len(val) == 1 and np.isfinite(val[0]["val/loss"]),
            f"cli run: step {state.step}, losses {cli_losses}, val {val}")
    require(counts.get("causal_attention_bwd") == n_layers * 2 * 5,
            f"cli run: backward launches {counts} (expected {n_layers * 2 * 5})")
    ckpt = out / "checkpoints"
    require((ckpt / "step_5.pt").exists() and list((out / "sample" / "5").glob("*.mid")),
            "cli run: no checkpoint or no example pieces")
    exported = load_state_dict(str(ckpt / "model.safetensors"))
    require(sorted(exported) == sorted(state.params) and all(
        np.array_equal(exported[n], p.detach().cpu().numpy()) for n, p in state.params.items()),
        "model.safetensors differs from the final weights")
    del state, exported
    torch.cuda.empty_cache()
    argv[argv.index("--max-step") + 1] = "6"
    resumed = cli.main(argv + ["--resume", "1", "--gen-example-interval", "0"])
    require(resumed.step == 6 and resumed.opt_state.count == 6,
            f"resume: step {resumed.step}, updates {resumed.opt_state.count}")
    del resumed
    torch.cuda.empty_cache()
    emit({"phase": "train", "config": "tv2o-medium", "compute": "bf16, f32 master",
          "cli": {"steps": 5, "seconds": cli_s, "losses": cli_losses, "val": val[0],
                  "launches": counts}, "card": card})

    timed_training(card, config, batch_of, torch.bfloat16)
    fp32 = timed_training(card, config, batch_of, torch.float32)
    require(fp32["launches"].get("causal_attention_bwd") == n_layers * 2 * 10,
            f"f32 timed loop: backward launches {fp32['launches']}")
    return {"causal_attention_bwd": counts["causal_attention_bwd"],
            "causal_attention_f32": fp32["launches"]["causal_attention"],
            "causal_attention_bwd_f32": fp32["launches"]["causal_attention_bwd"]}


# the kernels phase 7 must see launched, as the profiler names them
DECODE_PROFILE_KERNELS = ("event_loop_kernel", "token_row_kernel", "fused_step_kernel")
# a greedy pick of the artifact runner that differs from generate's must be a
# near-tie: f32 logits of two f32 implementations (dense attention and cuBLAS
# products against the paged kernel) differ by ~1e-5 at these magnitudes
ARTIFACT_TIE_GAP = 1e-3


def profiled_kernel_counts(run, names) -> dict:
    """torch.profiler over ``run()``: launches of the device kernels whose
    names hold each of ``names``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {n: sum(c for k, c in events if n in k) for n in names}


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def first_difference(a, b):
    """(event, step) of the first token where rows ``a`` and ``b`` [L, T]
    differ over their common length, or None."""
    import numpy as np

    n = min(len(a), len(b))
    diff = np.argwhere(a[:n] != b[:n])
    return None if not len(diff) else tuple(int(x) for x in diff[0])


def phase_api(card: str, corpus) -> dict:
    """The user surface at tv2o-medium's full width, on the weights phase
    6's CLI wrote (``build/chip_smoke_train/run/checkpoints``):

    1. ``MIDIModel.from_pretrained`` (bf16) and ``generate`` at bs=32 on
       the default path, 259 events, twice, in turns with
       ``sampling.generate`` on the same arguments: events/s of both (the
       facade adds no work), the grammar, the decode kernels' launches
       (wrapper counts and torch.profiler);
    2. ``train.cli --task lora --ckpt`` for 5 steps (r 64, alpha 128):
       finite losses, the backward kernel launched (12 + 3 layers) x 2
       microbatches x 5 times, the adapter written; then
       ``load_merge_lora`` of it and ``generate`` (bs=32) through the
       decode kernels;
    3. the LoRA step (r 64) and the full step under every remat policy
       (none, full, dots, dots_all) timed on one fixed batch (bs 2 x acc 2
       x 2048 events, bf16 compute): a falling loss, ms per step, peak
       memory, the attention kernels' device ms by kernel; the forward
       kernel's launches per step show what each policy recomputes (none
       and dots_all: once a layer a microbatch; full and dots: twice);
    4. ``publish`` of the run directory in bf16 and fp32, reloaded: the
       run's weights, cast;
    5. ``export_artifacts`` at batch 1, f32 weights, max_seq 256 (seconds
       timed), and ``ArtifactGenerator``'s greedy rows against
       ``MIDIModel.generate(greedy=True)`` with the same f32 weights, each
       continuing four 16-event prompts of the corpus up to 80 events:
       identical, but where the first differing pick is a near-tie (its
       logit gap within ARTIFACT_TIE_GAP, by ``tie_gaps``).

    Returns the wrapper launches of steps 1 and 2 by kernel."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.interop import load_file
    from midi_model_tpu_torch.interop.export import export_artifacts
    from midi_model_tpu_torch.interop.publish import publish
    from midi_model_tpu_torch.models import MIDIModel
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.sampling import build_mask_table, generate
    from midi_model_tpu_torch.serve.artifact_runner import ArtifactGenerator
    from midi_model_tpu_torch.train import cli
    from midi_model_tpu_torch.train.checkpoint import CheckpointManager

    config, work, batch_of = corpus
    tokenizer = config.tokenizer
    table = build_mask_table(tokenizer)
    n_layers = config.net.num_layers + config.net_token.num_layers
    ckpt = work / "run" / "checkpoints"
    launches = {}

    # 1. the facade on the default decode path
    model = MIDIModel.from_pretrained(str(ckpt))
    require(model.model.dtype == torch.bfloat16 and model.device.type == "cuda",
            f"from_pretrained: {model.model.dtype} on {model.device}")
    model.generate(batch_size=32, max_len=20, seed=0)  # warm-up
    # the facade and sampling.generate on the same arguments, in turns
    rates = {"MIDIModel.generate": [], "sampling.generate": []}
    for seed, facade in ((1, True), (1, False), (2, False), (2, True)):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rows = (model.generate(batch_size=32, max_len=260, seed=seed) if facade
                else generate(model.model, config, batch_size=32, max_len=260, seed=seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        require(rows.shape[0] == 32 and rows.shape[1] > 1, f"MIDIModel.generate rows {rows.shape}")
        check_rows(rows[:, 1:], table, tokenizer, "MIDIModel.generate bs=32")
        rates["MIDIModel.generate" if facade else "sampling.generate"].append(
            32 * (rows.shape[1] - 1) / dt)
    for name in ("event_loop", "token_row", "fused_step", "causal_attention"):
        require(counts.get(name, 0) > 0, f"MIDIModel.generate never launched {name}: {counts}")
    add_counts(launches, counts)
    profiled = profiled_kernel_counts(
        lambda: model.generate(batch_size=32, max_len=20, seed=3),
        DECODE_PROFILE_KERNELS + ATTENTION_FWD_KERNELS)
    require(all(profiled[n] for n in DECODE_PROFILE_KERNELS + ("fwd_wgmma_kernel",)),
            f"MIDIModel.generate's profile: {profiled}")
    emit({"phase": "api_generate", "batch": 32, "events": rows.shape[1] - 1,
          "events_per_s": rates, "launches": counts, "profiled_launches_19_events": profiled,
          "card": card})

    # 2. LoRA fine-tune through the CLI, then merge the adapter and generate
    out = work / "lora"
    argv = train_cli_argv(work, out, 5) + [
        "--task", "lora", "--ckpt", str(ckpt / "model.safetensors"), "--lora-r", "64",
        "--lora-alpha", "128", "--lr", "1e-3", "--gen-example-interval", "0"]
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    state = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    logs = [json.loads(line) for line in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    lora_losses = [r["train/loss"] for r in logs if "train/loss" in r]
    adapter = out / "checkpoints" / "adapter"
    require(state.step == 5 and all(".lora_" in n for n in state.params)
            and len(lora_losses) == 5 and all(np.isfinite(lora_losses)),
            f"lora cli: step {state.step}, losses {lora_losses}")
    require(counts.get("causal_attention_bwd") == n_layers * 2 * 5,
            f"lora cli: backward launches {counts} (expected {n_layers * 2 * 5})")
    require((adapter / "adapter_model.safetensors").exists()
            and (adapter / "adapter_config.json").exists(), "lora cli: no adapter written")
    add_counts(launches, counts)
    del state
    torch.cuda.empty_cache()
    q0 = model.model.net.layers[0].self_attn.q_proj.weight.detach().clone()
    model.load_merge_lora(str(adapter), alpha=128.0)
    moved = float((model.model.net.layers[0].self_attn.q_proj.weight - q0).abs().max())
    require(moved > 0, "load_merge_lora left the weights as they were")
    _build.LAUNCHES.clear()
    merged_rows = model.generate(batch_size=32, max_len=40, seed=4)
    torch.cuda.synchronize()
    merged_counts = dict(_build.LAUNCHES)
    check_rows(merged_rows[:, 1:], table, tokenizer, "generate after load_merge_lora")
    require(merged_counts.get("event_loop", 0) > 0 and merged_counts.get("token_row", 0) > 0,
            f"generate after load_merge_lora: {merged_counts}")
    emit({"phase": "api_lora_cli", "steps": 5, "rank": 64, "alpha": 128, "seconds": cli_s,
          "losses": lora_losses, "launches": counts, "merged_q_proj_max_change": moved,
          "merged_generate_launches": merged_counts, "card": card})
    del model, q0
    torch.cuda.empty_cache()

    # 3. the LoRA step and the remat policies on one fixed batch
    lora = timed_training(card, config, batch_of, torch.bfloat16, steps=5, lora_rank=64,
                          lr=1e-3, phase="api_lora_timed")
    require(lora["launches"].get("causal_attention_bwd") == n_layers * 2 * 5,
            f"lora step: backward launches {lora['launches']}")
    policies = {}
    for remat in (False, "full", "dots", "dots_all"):
        r = timed_training(card, config, batch_of, torch.bfloat16, steps=4, remat=remat,
                           phase="api_remat_timed")
        recomputes = remat in ("full", "dots")
        want = n_layers * 2 * 4 * (2 if recomputes else 1)
        require(r["launches"].get("causal_attention") == want,
                f"remat {remat!r}: forward launches {r['launches']} (expected {want})")
        policies[str(remat or "none")] = {k: r[k] for k in ("ms_per_step", "peak_memory_gb",
                                                            "train_tokens_per_s")}
    emit({"phase": "api_remat", "policies": policies,
          "lora_step": {k: lora[k] for k in ("ms_per_step", "peak_memory_gb",
                                              "train_tokens_per_s")}, "card": card})

    # 4. publish the run directory, bf16 and fp32, and read it back
    saved = CheckpointManager(str(ckpt), config).load_params()
    pub = {}
    for dtype, torch_dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        t0 = time.perf_counter()
        path = publish(str(ckpt), "tv2o-medium", str(work / f"published_{dtype}"), dtype=dtype)
        pub[dtype] = time.perf_counter() - t0
        sd = load_file(f"{path}/model.safetensors")
        require(sorted(sd) == sorted(saved) and all(
            np.array_equal(sd[n], p.to(torch_dtype).float().numpy()) for n, p in saved.items()),
            f"publish {dtype}: the file is not the run's weights")
        reloaded = MIDIModel.from_pretrained(path, dtype=torch.float32)
        require(all(np.array_equal(p.detach().cpu().numpy(), sd[n])
                    for n, p in reloaded.model.named_parameters()),
                f"publish {dtype}: from_pretrained differs from the file")
        del reloaded, sd
    del saved
    emit({"phase": "api_publish", "seconds": pub, "card": card})

    # 5. torch.export programs and the artifact runner against generate, f32,
    #    continuing four 16-event prompts of the corpus (a greedy row from
    #    the bos prompt alone ends at eos within a few events)
    f32 = MIDIModel.from_pretrained(str(ckpt), dtype=torch.float32)
    t0 = time.perf_counter()
    export_artifacts(f32.model, config, str(work / "artifacts"), batch_size=1, max_seq=256,
                     dtype=torch.float32)
    export_s = time.perf_counter() - t0
    runner = ArtifactGenerator(str(work / "artifacts"))
    prompts = batch_of(4, 16, 2)
    compared, art_events, art_s, differences = 0, 0, 0.0, []
    for prompt in prompts:
        t0 = time.perf_counter()
        art = runner.generate(prompt=prompt[None], max_len=80, greedy=True)
        art_s += time.perf_counter() - t0
        ref = f32.generate(prompt=prompt, batch_size=1, max_len=80, greedy=True)
        check_rows(art[:, 16:], table, tokenizer, "artifact runner")
        art_events += art.shape[1] - 16
        where = first_difference(art[0], ref[0])
        if where is None:
            require(art.shape == ref.shape, f"artifact rows {art.shape}, generate's {ref.shape}")
            compared += art.shape[1] - 16
            continue
        event = where[0]
        compared += event - 16
        with torch.no_grad():
            hidden, _ = f32.model(torch.as_tensor(ref[:, :event], device="cuda"))
        gaps = tie_gaps(f32.model, hidden[:, -1], torch.as_tensor(art[:, event], device="cuda"),
                        torch.as_tensor(ref[:, event], device="cuda"), torch.ones(1, device="cuda"))
        differences.append({"at": where, "logit_gap": gaps[0]})
        require(abs(gaps[0]) <= ARTIFACT_TIE_GAP,
                f"artifact rows differ from generate's at {where}, logit gap {gaps[0]}")
    emit({"phase": "api_export", "batch": 1, "max_seq": 256, "dtype": "float32",
          "export_seconds": export_s, "prompts": len(prompts), "prompt_events": 16,
          "artifact_events": art_events, "artifact_events_per_s": art_events / art_s,
          "events_compared_identical": compared, "near_tie_differences": differences,
          "card": card})
    del f32, runner
    torch.cuda.empty_cache()
    return launches


APP_SESSIONS = ("custom", "midi", "no_cc", "continue")
APP_EVENTS = 256
# the preprocessing corpus: the golden blobs copied under distinct names
PREPROCESS_FILES = 2000
NATIVE_ROUNDS = 20


def native_and_preprocess(card: str) -> None:
    """Phase 8's host side: both native extensions built with g++ (no
    Python-path fallback allowed here), held to the Python paths on every
    golden, timed beside them; then ``train.preprocess.main`` over a corpus
    of ~2,000 golden copies with the native build and without it
    (``MIDI_TPU_NATIVE=0``): the same verdicts, files/s of each."""
    import contextlib
    import gc
    import io
    import os
    import statistics
    import tempfile
    import threading

    from midi_model_tpu_torch import native
    from midi_model_tpu_torch.midi import codec
    from midi_model_tpu_torch.native import build as native_build
    from midi_model_tpu_torch.tokenizer import MIDITokenizer
    from midi_model_tpu_torch.tokenizer import base as tok_base
    from midi_model_tpu_torch.train import preprocess

    t0 = time.perf_counter()
    try:
        paths = native_build.build(verbose=False)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"check failed: the native build: {exc.stderr}") from exc
    build_s = time.perf_counter() - t0
    codec_mod, scan_mod = native.native_codec(), native.native_tokenizer_scan()
    require(codec_mod is not None and scan_mod is not None,
            f"the native extensions did not load from {paths}")
    goldens = pickle.loads((ROOT / "tests/golden/codec.pkl").read_bytes())
    for name, g in goldens.items():
        require(codec_mod.midi2score(g["bytes"])
                == codec._py_opus2score(codec._py_midi2opus(g["bytes"])),
                f"native midi2score differs from Python on {name}")
    good = {k: g["bytes"] for k, g in goldens.items() if not k.startswith("bad_")}
    scores = {k: codec_mod.midi2score(b) for k, b in good.items()}
    native_scan = tok_base._native_scan

    def tokenize_all(tok):
        return [tok.tokenize(s) for s in scores.values()]

    def timed(fn):
        """ms of one call, with the collector off (as timeit): after the earlier
        phases its full passes over the heap would land in either path's timing"""
        gc.collect()
        gc.disable()
        try:
            t = time.perf_counter()
            fn()
            return (time.perf_counter() - t) * 1e3
        finally:
            gc.enable()

    def python_scan(fn):
        tok_base._native_scan = lambda: None
        try:
            return fn()
        finally:
            tok_base._native_scan = native_scan

    # NATIVE_ROUNDS rounds of one pass over the blobs a path, the two paths
    # in turns (the host is shared): each path's least and median pass, and
    # the spread of the rounds' own ratios
    samples = {}
    for version in ("v1", "v2"):
        tok = MIDITokenizer(version)
        rows = tokenize_all(tok)
        require(python_scan(lambda: tokenize_all(tok)) == rows,
                f"{version}: the native scan's rows differ")
        for _ in range(NATIVE_ROUNDS):
            samples.setdefault(f"tokenize_{version}_python_ms", []).append(
                python_scan(lambda: timed(lambda: tokenize_all(tok))))
            samples.setdefault(f"tokenize_{version}_native_ms", []).append(
                timed(lambda: tokenize_all(tok)))
    for _ in range(NATIVE_ROUNDS):
        samples.setdefault("midi2score_native_ms", []).append(
            timed(lambda: [codec_mod.midi2score(b) for b in good.values()]))
        samples.setdefault("midi2score_python_ms", []).append(
            timed(lambda: [codec._py_opus2score(codec._py_midi2opus(b))
                           for b in good.values()]))
    times = {k: min(v) for k, v in samples.items()}
    medians = {k: statistics.median(v) for k, v in samples.items()}
    ratios, median_ratios, round_ratios = {}, {}, {}
    for k in ("midi2score", "tokenize_v1", "tokenize_v2"):
        py, nat = f"{k}_python_ms", f"{k}_native_ms"
        ratios[k] = times[py] / times[nat]
        median_ratios[k] = medians[py] / medians[nat]
        each = [p / n for p, n in zip(samples[py], samples[nat])]
        round_ratios[k] = [min(each), statistics.median(each), max(each)]
    emit({"phase": "app_native", "build_s": build_s, "blobs": len(good),
          "rounds": NATIVE_ROUNDS, "threads": threading.active_count(),
          "least_ms_per_pass": times, "median_ms_per_pass": medians,
          "python_over_native": ratios, "python_over_native_of_medians": median_ratios,
          "round_ratios_min_median_max": round_ratios, "card": card})

    jobs = min(8, len(os.sched_getaffinity(0)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_app_") as tmp:
        src = Path(tmp) / "corpus"
        src.mkdir()
        copies = -(-PREPROCESS_FILES // len(good))
        for i in range(copies):
            for name, data in good.items():
                (src / f"{name}_{i:03d}.mid").write_bytes(data)
        # one copy of each blob through process_file in this process: the
        # per-file cost without the pool's start-up (spawned workers import torch)
        one_copy = [(str(src / f"{name}_000.mid"), "v2", True) for name in good]
        serial = {}
        for label, scan in (("native", native_scan), ("python", lambda: None)):
            native_codec = codec._native_codec
            tok_base._native_scan = scan
            if label == "python":
                codec._native_codec = lambda: None
            try:
                verdicts = [preprocess.process_file(a) for a in one_copy]
                serial[label] = (min(timed(lambda: [preprocess.process_file(a) for a in one_copy])
                                     for _ in range(3)) / len(one_copy), verdicts)
            finally:
                tok_base._native_scan, codec._native_codec = native_scan, native_codec
        require(serial["native"][1] == serial["python"][1],
                f"process_file verdicts: native {serial['native'][1]}, python {serial['python'][1]}")
        runs = {}
        for label in ("native", "python"):
            dst = Path(tmp) / label
            before = os.environ.get("MIDI_TPU_NATIVE")
            os.environ["MIDI_TPU_NATIVE"] = "1" if label == "native" else "0"
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    accepted, rejected = preprocess.main(
                        ["--src", str(src), "--dst", str(dst), "--jobs", str(jobs)])
                seconds = time.perf_counter() - t0
            finally:
                if before is None:
                    os.environ.pop("MIDI_TPU_NATIVE")
                else:
                    os.environ["MIDI_TPU_NATIVE"] = before
            verdicts = {}
            for path in dst.rglob("*.mid"):
                verdicts.setdefault(str(path.parent.relative_to(dst)), set()).add(path.name)
            runs[label] = {"seconds": seconds, "files_per_s": (accepted + rejected) / seconds,
                           "accepted": accepted, "rejected": rejected,
                           "by_reason": {k: len(v) for k, v in sorted(verdicts.items())},
                           "verdicts": verdicts}
        n_files = copies * len(good)
        require(runs["native"]["verdicts"] == runs["python"]["verdicts"]
                and runs["native"]["accepted"] + runs["native"]["rejected"] == n_files,
                f"preprocess verdicts: native {runs['native']['by_reason']}, "
                f"python {runs['python']['by_reason']}")
    for run in runs.values():
        del run["verdicts"]
    emit({"phase": "app_preprocess", "files": n_files, "jobs": jobs, "runs": runs,
          "native_speedup": runs["python"]["seconds"] / runs["native"]["seconds"],
          "process_file_ms_serial": {k: v[0] for k, v in serial.items()},
          "process_file_serial_speedup": serial["python"][0] / serial["native"][0],
          "card": card})


def app_sessions(service, requests: dict, continue_from):
    """One round of concurrent sessions on threads, as the UI's handlers
    call the service: the custom-prompt, MIDI-prompt and allow_cc=False
    sessions through ``run`` with their prompt rows, the last through
    ``continue_run`` from ``continue_from`` (each row continues its own).
    Returns {session: (prompt [B, P, T], generated [B, n, T], seconds to
    the first chunk or None)} and the round's wall seconds."""
    import threading

    import numpy as np

    results, errors = {}, []

    def session(name):
        try:
            req = requests[name]
            t0 = time.perf_counter()
            if name == "continue":
                prompt = np.asarray(continue_from)
                stream = service.continue_run(req, prompt, [0], select=0)
            else:
                if name == "midi":
                    rows, dpc, dch = service.midi_prompt(req), False, None
                else:
                    rows, dpc, dch = service.custom_prompt(req)
                prompt = np.asarray([rows] * service.batch_size)
                stream = service.run(req, prompt_rows=rows, disable_patch_change=dpc,
                                     disable_channels=dch)
            # a session whose every variation ends on eos at once streams nothing
            chunks = [np.zeros((service.batch_size, 0, prompt.shape[2]), np.int64)]
            first = None
            for chunk in stream:
                first = first if first is not None else time.perf_counter() - t0
                chunks.append(chunk)
            results[name] = (prompt, np.concatenate(chunks, axis=1), first)
        except BaseException as exc:  # re-raised by the caller's thread
            errors.append(exc)

    names = [n for n in APP_SESSIONS if n in requests]
    threads = [threading.Thread(target=session, args=(n,)) for n in names]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    require(set(results) == set(names), f"sessions unfinished: {set(names) - set(results)}")
    return results, wall


def check_sessions(service, requests: dict, results: dict, out_dir: Path, what: str):
    """Every streamed row obeys the grammar tables, a session with
    instruments uses no disabled channel and no patch change, the
    allow_cc=False session no control change; ``finish`` writes .mid files
    that ``midi2score`` reads back.  Returns the generated events."""
    import numpy as np

    from midi_model_tpu_torch.midi import midi2score
    from midi_model_tpu_torch.sampling import build_mask_table

    tok = service.tokenizer
    table = build_mask_table(tok)
    events = 0
    for name, (prompt, rows, _) in results.items():
        flat = rows.reshape(-1, rows.shape[-1])
        flat = flat[flat[:, 0] != tok.pad_id]  # a variation that ended is pad-filled
        events += len(flat)
        check_rows(flat, table, tok, f"{what} {name}")
        req = requests[name]
        if req.instruments:
            _, _, disabled = service.custom_prompt(req)
            banned = {tok.vocab.param_base("channel") + c for c in disabled}
            require(not (set(flat.ravel().tolist()) & banned)
                    and not (flat[:, 0] == tok.event_ids["patch_change"]).any(),
                    f"{what} {name}: a disabled channel or a patch change")
        if not req.allow_cc:
            require(not (flat[:, 0] == tok.event_ids["control_change"]).any(),
                    f"{what} {name}: a control change with allow_cc off")
        seqs = np.concatenate([prompt, rows.astype(prompt.dtype)], axis=1)
        paths = service.finish(seqs, out_dir=str(out_dir / f"{what}_{name}"))
        require(len(paths) == service.batch_size, f"{what} {name}: {len(paths)} files")
        for p in paths:
            score = midi2score(Path(p).read_bytes())
            require(score[0] == 480 and len(score) > 1, f"{what} {name}: {p} reads back {score[:1]}")
    return events


def phase_app(card: str, ckpt=None) -> dict:
    """The serving app at tv2o-medium's full width (``serve/app.py``):

    1. the native extensions and preprocessing (``native_and_preprocess``);
    2. ``MidiGenerationService`` loaded as ``main`` loads it (``--ckpt``:
       ``load_model`` with config.json beside the checkpoint, bf16; random
       bf16 weights when ``ckpt`` is None) on the batched path
       (``batcher_slots`` 32, ``chunk_size`` 16, ``context_limit`` 2048),
       ``batch_size`` 4: one custom-prompt session alone, then four
       sessions of 256 events at once on threads (the custom prompt with
       instruments, bpm, time and key signature; a MIDI prompt from a
       golden blob; allow_cc off; a continuation of the first session's
       output); the same rounds again with the shared batcher's eos
       disabled (every session to its budget: the streaming rate, as phase
       5's budget churn).  The seeded custom session must give the same
       rows alone and beside the others; events/s over all sessions, the
       seconds to each session's first chunk;
    3. one aligned session (``batcher_slots`` 0): ``sampling.generate`` on
       a worker thread through the 8-event loop;
    4. ``examples/demo_torch.py --events 64 --batch 4`` in a subprocess on
       the card.

    Returns the wrapper launches of steps 2 and 3 by kernel."""
    import tempfile

    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.serve import BatcherService, ContinuousBatcher
    from midi_model_tpu_torch.serve import app
    from midi_model_tpu_torch.serve.app import GenerationRequest, MidiGenerationService

    t_phase = time.perf_counter()
    native_and_preprocess(card)
    if ckpt is not None:
        model, config = app.load_model(str(ckpt), "auto", device="cuda")
    else:
        config = MIDIModelConfig.from_name("tv2o-medium")
        model = init_model(config, seed=8, dtype=torch.bfloat16, device="cuda")
    require(model.dtype == torch.bfloat16 and model.device.type == "cuda",
            f"app model: {model.dtype} on {model.device}")
    blob = pickle.loads((ROOT / "tests/golden/codec.pkl").read_bytes())["rand_01"]["bytes"]
    requests = {
        "custom": GenerationRequest(instruments=["Acoustic Grand", "Violin", "Flute"],
                                    drum_kit="Standard", bpm=120, time_signature="4/4",
                                    key_signature=15, gen_events=APP_EVENTS, seed=1),
        "midi": GenerationRequest(midi_bytes=blob, midi_events=128, gen_events=APP_EVENTS,
                                  seed=2),
        "no_cc": GenerationRequest(bpm=100, allow_cc=False, gen_events=APP_EVENTS, seed=3),
        "continue": GenerationRequest(gen_events=APP_EVENTS, seed=4),
    }
    service = MidiGenerationService(model, config, batch_size=4, chunk_size=16,
                                    context_limit=2048, batcher_slots=32)
    require(service.batcher_service.batcher.path == "event_loop",
            f"app batcher path: {service.batcher_service.batcher.path}")
    launches = {}
    rounds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_app_out_") as tmp:
        out_dir = Path(tmp)
        for label in ("eos", "budget"):
            if label == "budget":  # the shared batch with eos disabled
                service.batcher_service.close()
                service.batcher_service = BatcherService(ContinuousBatcher(
                    model, config, n_slots=32, max_seq=2048, chunk=16, disable_eos=True))
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            alone, alone_s = app_sessions(service, {"custom": requests["custom"]}, None)
            sessions, wall = app_sessions(service, requests, np.concatenate(
                [alone["custom"][0], alone["custom"][1]], axis=1))
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            add_counts(launches, counts)
            events = check_sessions(service, requests, sessions, out_dir, f"app_{label}")
            same = np.array_equal(alone["custom"][1], sessions["custom"][1])
            require(same, f"app {label}: the seeded session's rows alone "
                    f"{alone['custom'][1].shape} differ from its rows beside others "
                    f"{sessions['custom'][1].shape}")
            require(counts.get("event_loop_ragged", 0) > 0
                    and counts.get("causal_attention", 0) > 0,
                    f"app {label}: launches {counts}")
            firsts = sorted(s[2] for s in sessions.values() if s[2] is not None)
            rounds[label] = {
                "events": events, "wall_s": wall, "events_per_s": events / wall,
                "first_chunk_s": {n: s[2] for n, s in sessions.items()},
                "first_chunk_s_p50": float(np.median(firsts)) if firsts else None,
                "first_chunk_s_max": firsts[-1] if firsts else None,
                "rows_per_session": {n: int(s[1].shape[1]) for n, s in sessions.items()},
                "alone": {"events": int((alone["custom"][1][:, :, 0]
                                         != config.tokenizer.pad_id).sum()),
                          "wall_s": alone_s, "first_chunk_s": alone["custom"][2]},
                "launches": counts}
        service.close()
        require(rounds["budget"]["events"] == 4 * 4 * APP_EVENTS,
                f"app budget round: {rounds['budget']['events']} events")
        emit({"phase": "app_batched", "slots": 32, "batch_size": 4, "chunk_size": 16,
              "context_limit": 2048, "weights": "checkpoint" if ckpt else "random",
              "rounds": rounds, "card": card})

        # 3. the aligned path: one session, generate on a worker thread
        aligned = MidiGenerationService(model, config, batch_size=4, chunk_size=16,
                                        context_limit=2048)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        one, wall = app_sessions(aligned, {"custom": requests["custom"]}, None)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        add_counts(launches, counts)
        events = check_sessions(aligned, requests, one, out_dir, "app_aligned")
        require(counts.get("event_loop", 0) > 0, f"app aligned: launches {counts}")
        emit({"phase": "app_aligned", "batch_size": 4, "events": events, "wall_s": wall,
              "events_per_s": events / wall, "first_chunk_s": one["custom"][2],
              "launches": counts, "card": card})
        del aligned, service, model
        torch.cuda.empty_cache()

        # 4. the demo script on the card
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "demo_torch.py"), "--events", "64",
             "--batch", "4", "--out", str(out_dir / "demo")],
            capture_output=True, text=True, timeout=600, cwd=str(ROOT))
        demo_s = time.perf_counter() - t0
        mids = sorted((out_dir / "demo").glob("*.mid"))
        require(proc.returncode == 0 and len(mids) == 4,
                f"demo_torch.py: rc {proc.returncode}, {len(mids)} files: {proc.stderr[-2000:]}")
        emit({"phase": "app_demo", "seconds": demo_s, "files": len(mids),
              "stdout_tail": proc.stdout.strip().splitlines()[-5:], "card": card})
    emit({"phase": "app", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "card": card})
    return launches


# ---- phase 9: the (data, model) mesh ---------------------------------------
#
# Several ranks share the one card: NCCL refuses two ranks on one device, so
# the multi-rank runs are processes on cuda:0 over gloo (which all-reduces
# CUDA tensors through the host); one world-size-1 run goes over NCCL.  No
# reading here is a scaling figure: the ranks share the card.

MESH_SEED = 9
# tv2o-large bf16 at tp=2 against one device: the hidden after all 24 layers
# and the final norm at each prompt's last row.  Two correct bf16 stacks
# differ there by the rounding flips that summation order seeds and depth
# compounds.  The yardstick, as BF16_DEEP_TOL's: the single-device stack on
# the CPU against the same on the card, on the prompt's first two rows
# (``cpu_vs_card``, printed by every run: 0.0703 in runs AK and AM, PERF.md
# section 6); the bound is 1.6x it, rounded up, and holds the tp hidden on
# those two rows (0.0791, run AM).  The largest difference over all 32 rows
# is printed beside it (0.109 in AK and AM).
BF16_TP_DEEP_TOL = 0.115
# f32 weights, f32 pools: the same hidden after the prefill, bounded the same
# way from the f32 stack's CPU-against-card reading on rows 0-1: 1.41e-5 in
# run AO (PERF.md section 6), so 1.6x it, rounded up; tp there 1.20e-5 (1.70e-5
# over all 32 rows).
F32_TP_DEEP_TOL = 2.5e-5
# f32 weights, int8 pools: the prefill never reads the pools, so the hidden
# is taken after a greedy 16-event decode chunk, which attends over them at
# every layer, on the rows whose 16 events agree; bounded from the same
# chunk's CPU-against-card reading on rows 0-1: 3.68e-4 in run AO, so 1.6x
# it, rounded up; tp there 1.68e-4 (3.93e-4 over all 32 rows).
INT8_TP_DEEP_TOL = 6e-4
# tp=2 sums each row-parallel product from two halves, which differs from one
# device's product in the last bits, and 24 layers carry that to the logits:
# no tp run can promise every row identical.  The runs are greedy, and every
# row that differs must part at a near-tie: at its first differing step the
# single-device model's logit of its own pick beats the tp pick by at most
# TIE_GAPS[kind].  f32: as ARTIFACT_TIE_GAP.  int8 pools: a last-bit
# difference now and then crosses a quantization boundary and moves a cached
# value a whole int8 step (1/127 of its head's largest); the rows that parted
# did so at gaps of 0.0034 and 0.0053 (runs AM, AN), and the bound is about 4x
# the larger.  bf16: as the token row's greedy check (phase 2).
TIE_GAPS = {"f32": ARTIFACT_TIE_GAP, "int8": 0.02, "bf16": 0.0625}
# the tp=2 runs: name -> (weights' dtype, tie-gap kind, int8 pools, the
# hidden compared with one device's: after the "prefill" or the "chunk",
# the tp batcher's requests: the first n of the queue).  The tp batcher's
# time goes to its admissions (prefills whose all-reduces carry [G, S,
# 1024] activations between processes): 19-22 s for 48 requests in runs AO
# and AQ, 11-14 s for 16.  Each takes 16, all admitted at once (the dp x tp
# run holds f32 slot reuse under tp to one device's rows).
TP_RUNS = {"f32": ("float32", "f32", False, "prefill", 16),
           "f32_int8": ("float32", "int8", True, "chunk", 16),
           "bf16": ("bfloat16", "bf16", False, "prefill", 16)}
# the events ``generate_tp`` and its single-device reference decode after
# the 256-event prompt, few, as the tp batchers' requests: phase 9's
# training parts share the script's time
TP_EVENTS = 32
TP_DEEP_TOLS = {"f32": F32_TP_DEEP_TOL, "f32_int8": INT8_TP_DEEP_TOL,
                "bf16": BF16_TP_DEEP_TOL}
TP_CHUNK = 16  # the events of the decode chunk after the prefill
MESH_LIMITS = dict(init_timeout_s=300.0)  # a collective that waits longer fails


# The Mamba-2 kernels against their plain versions (ops/ssm.py), bf16 inputs
# on the card, relative to the largest magnitude of the plain version's
# output: where the f32 sums of the two differ in their last bits, a value
# the plain version rounds to bf16 before a product (the weighted scores,
# the weighted x, the state the rows read) can round the other way, a
# relative 2^-8 (3.9e-3) on that term; errors of whole sums are far smaller
SSM_SCAN_TOL = 4e-3
# the step: the same bf16 roundings (x, B, C after the convolution) and the
# gated output's bf16 rounding (half an ulp: 2^-9 of a value)
SSM_STEP_TOL = 4e-3


def check_ssm(card: str, gen) -> dict:
    """``ops.ssm.ssm_scan`` and ``ssm_step`` against their plain versions at
    granite-4.0-h-micro's widths (64 heads x 64, state 128, one group,
    convolution 4, chunk 256): the scan on one bucket of 1,024 rows holding
    prompts of 1, 3, 255, 256, 257 and 512 rows (shorter than the
    convolution, a chunk's edges, two chunks), each prompt's y and final
    state; the step on 32 slots from those states, eight rows in turn,
    outputs and both states.  Inputs as a model makes them: the
    convolution of N(0, 1) rows (weights uniform +-0.5) and SiLU, dt from
    mamba_ssm's dt_bias range, A = -exp(U(0, ln 16)).  Times each wrapper
    call (``time_ms``) beside its bytes' floor, and finds HMMA in the
    scan's SASS.  Also the decode step's elementwise kernels
    (``ops.hybrid_norm``) against their plain versions at 32 rows of 2,048:
    the residual add to the bit, the norm and SwiGLU to two bf16 roundings
    (their f32 sums and exponentials differ in the last bits)."""
    import re

    import torch
    import torch.nn.functional as F

    from midi_model_tpu_torch.ops import _build, hybrid_norm, ssm

    dev = torch.device("cuda")
    bf = torch.bfloat16
    h, p, n, k, chunk, slots, bucket = 64, 64, 128, 4, 256, 32, 1024
    inner = h * p
    conv = inner + 2 * n
    lengths = [1, 3, 255, 256, 257, 512]
    g_n = len(lengths)

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    conv_w = uniform((conv, 1, k), -0.5, 0.5).to(bf)
    conv_b = uniform((conv,), -0.5, 0.5).to(bf)
    dt_bias = uniform((h,), -6.91, -2.25).to(bf)
    a_log = uniform((h,), 0.0, math.log(16.0)).to(bf)
    d = torch.ones(h, device=dev, dtype=bf)
    norm_w = torch.ones(inner, device=dev, dtype=bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    xbc = torch.randn((g_n, bucket, conv), device=dev, generator=gen).to(bf)
    xbc, _ = ssm.causal_conv(xbc, conv_w, conv_b, lens)
    x = xbc[..., :inner].view(g_n, bucket, h, p)
    b = xbc[..., inner:inner + n].view(g_n, bucket, 1, n)
    c = xbc[..., inner + n:].view(g_n, bucket, 1, n)
    dt = F.softplus(torch.randn((g_n, bucket, h), device=dev, generator=gen)
                    + dt_bias.float()).contiguous()
    a = -torch.exp(a_log.float())
    args = (x, b, c, dt, a, d.float(), lens)
    y, state = ssm.ssm_scan(*args, chunk=chunk)
    y_ref, state_ref = ssm.ssm_scan_reference(*args, chunk=chunk)
    scan_err = {"y": float((y - y_ref).abs().max() / y_ref.abs().max()),
                "state": float((state - state_ref).abs().max() / state_ref.abs().max())}
    for length, yr, sr, yk, sk in zip(lengths, y_ref, state_ref, y, state):
        require(bool((yk[length:] == 0).all()), f"ssm_scan: rows past {length} not zero")
        require(float((yk - yr).abs().max()) <= SSM_SCAN_TOL * float(yr.abs().max()),
                f"ssm_scan y, prompt of {length}: {scan_err}")
        require(float((sk - sr).abs().max()) <= SSM_SCAN_TOL * float(sr.abs().max()),
                f"ssm_scan state, prompt of {length}: {scan_err}")

    # the step: 32 slots from the scan's states (repeated), eight rows in turn
    ssm_k = state.repeat(-(-slots // g_n), 1, 1, 1)[:slots].contiguous()
    conv_k = torch.randn((slots, k - 1, conv), device=dev, generator=gen).to(bf)
    ssm_r, conv_r = ssm_k.clone(), conv_k.clone()
    step_err = 0.0
    for _ in range(8):
        row = torch.randn((slots, inner + conv + h), device=dev, generator=gen).to(bf)
        params = (conv_w, conv_b, dt_bias, a_log, d, norm_w, 1e-5)
        out = ssm.ssm_step(row, conv_k, ssm_k, *params, groups=1)
        ref = ssm.ssm_step_reference(row, conv_r, ssm_r, *params, groups=1)
        require(torch.equal(conv_k, conv_r), "ssm_step: the conv state differs")
        step_err = max(step_err, float((out.float() - ref.float()).abs().max()
                                       / ref.float().abs().max()),
                       float((ssm_k - ssm_r).abs().max() / ssm_r.abs().max()))
    require(step_err <= SSM_STEP_TOL, f"ssm_step: relative error {step_err}")

    row = torch.randn((slots, inner + conv + h), device=dev, generator=gen).to(bf)
    step_ms = time_ms(lambda: ssm.ssm_step(row, conv_k, ssm_k, conv_w, conv_b, dt_bias, a_log,
                                           d, norm_w, 1e-5, groups=1), 50)
    plain_step_ms = time_ms(lambda: ssm.ssm_step_reference(
        row, conv_r, ssm_r, conv_w, conv_b, dt_bias, a_log, d, norm_w, 1e-5, groups=1), 10)
    scan_ms = time_ms(lambda: ssm.ssm_scan(*args, chunk=chunk), 10)
    plain_scan_ms = time_ms(lambda: ssm.ssm_scan_reference(*args, chunk=chunk), 3)
    step_bytes = slots * (2 * 4 * h * p * n + 2 * 2 * (k - 1) * conv
                          + 2 * (inner + conv + h) + 2 * inner)
    scan_bytes = sum(length * (2 * (inner + 2 * n) + 4 * h + 4 * inner) + 4 * h * p * n
                     for length in lengths)
    scan_flops = 0.0
    for length in lengths:
        for i, q in enumerate(min(chunk, length - at) for at in range(0, length, chunk)):
            pairs = q * (q + 1) / 2
            scan_flops += 2 * pairs * n + h * (2 * pairs * p + 2 * q * n * p * (2 if i else 1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hmma, current = 0, False
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            current = "ssm_scan_kernel" in head.group(1)
        elif current and re.search(r"\bHMMA\b", line):
            hmma += 1
    require(hmma > 0, "ssm_scan_kernel holds no HMMA")

    # a value the two sides round to bf16 apart by one step (2^-7 of it at
    # most) is multiplied and rounded again: two steps at most
    ulp = 2.0 ** -6
    xs = torch.randn((slots, 2048), device=dev, generator=gen).to(bf)
    ys = torch.randn((slots, 2048), device=dev, generator=gen).to(bf)
    ws = (torch.rand(2048, device=dev, generator=gen) + 0.5).to(bf)
    x_k, h_k = hybrid_norm.add_rms_norm(xs, ys, ws, 1e-5, 0.22)
    x_r, h_r = hybrid_norm.add_rms_norm_reference(xs, ys, ws, 1e-5, 0.22)
    require(torch.equal(x_k, x_r), "add_rms_norm: the residual add differs")
    norm_err = float(((h_k.float() - h_r.float()).abs() / h_r.float().abs().clamp_min(1e-3)).max())
    require(norm_err <= ulp, f"add_rms_norm: {norm_err} of a value")
    gu = torch.randn((slots, 16384), device=dev, generator=gen).to(bf)
    sw_k = hybrid_norm.swiglu(gu).float()
    gate, up = gu.chunk(2, dim=-1)
    sw_r = (F.silu(gate) * up).float()
    swiglu_err = float(((sw_k - sw_r).abs() / sw_r.abs().clamp_min(1e-3)).max())
    require(swiglu_err <= ulp, f"swiglu: {swiglu_err} of a value")
    result = {"phase": "kernel", "name": "ssm", "prompts": lengths, "bucket": bucket,
              "slots": slots, "scan_rel_err": scan_err, "step_rel_err": step_err,
              "step_ms": step_ms, "step_plain_ms": plain_step_ms,
              "step_bound_ms": step_bytes / 3.35e9, "scan_ms": scan_ms,
              "scan_plain_ms": plain_scan_ms,
              "scan_bound_ms": max(scan_bytes / 3.35e9, scan_flops / 989e9),
              "scan_hmma": hmma, "add_rms_norm_rel_err": norm_err,
              "swiglu_rel_err": swiglu_err, "card": card}
    emit(result)
    return result


def cuda_settings() -> None:
    """Full-fp32 matmuls (no TF32) and f32 reductions in bf16 products, in
    every process that checks the kernels."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def mesh_prompt(tok, batch: int, p_len: int):
    """A random ``[batch, p_len, T]`` prompt with bos rows first."""
    import numpy as np

    rows = np.random.default_rng(MESH_SEED).integers(3, tok.vocab_size,
                                                     (batch, p_len, tok.max_token_seq))
    rows[:, 0] = tok.pad_id
    rows[:, 0, 0] = tok.bos_id
    return rows


def drive_queue(batcher, requests) -> dict:
    """Every request through ``batcher``; the records in request order, the
    wall seconds, the events decoded, the launches and the batcher's path."""
    import torch

    from midi_model_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    rids = [batcher.submit(p, budget, **extra) for p, budget, extra in requests]
    results = batcher.run_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(set(results) == set(rids), f"batcher: {len(rids) - len(results)} unfinished")
    records = [(results[r].rows, results[r].reason) for r in rids]
    return {"records": records, "wall_s": wall, "launches": dict(_build.LAUNCHES),
            "events": sum(len(rows) for rows, _ in records), "path": batcher.path}


def differing(records, ref) -> list:
    """Indices of the requests whose rows or reason differ."""
    return [i for i, ((rows, reason), (rows_r, reason_r)) in enumerate(zip(records, ref))
            if reason != reason_r or rows.shape != rows_r.shape or (rows != rows_r).any()]


def first_tie_gap(model, prompt, ref, got) -> float:
    """At the first event where ``got`` (rows [n, T]) departs from ``ref``:
    the single-device ``model``'s logit of ref's token minus got's at the
    first differing step, teacher-forced over the prompt, ref's earlier rows
    and the row's shared prefix (``tie_gaps``)."""
    import numpy as np
    import torch

    n = min(len(ref), len(got))
    diff = np.nonzero((ref[:n] != got[:n]).any(axis=1))[0]
    require(len(diff) > 0, "rows differ only in length")
    e = int(diff[0])
    seq = torch.as_tensor(np.concatenate([prompt, ref[:e]])[None], device=model.device)
    with torch.no_grad():
        hidden, _ = model(seq)
    row, row_r = (torch.as_tensor(x[e][None], device=model.device) for x in (got, ref))
    return tie_gaps(model, hidden[:, -1], row, row_r, torch.ones(1, device=model.device))[0]


def mesh_local_kernels(card: str) -> dict:
    """A tp=2 rank's kernels at its local shapes: the cell and streaming
    paged kernels at 8 heads x 64 against their plain versions (bf16, f32
    and int8 pools, ragged lengths, an inactive slot, a slot at capacity;
    the bounds of phase 2), timed warm beside the plain version with their
    byte bound; the causal attention forward at the admission prefill's
    [32, 1024, 8, 64] in bf16 and f32, timed beside SDPA."""
    import torch

    from midi_model_tpu_torch.ops import paged_allheads as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    heads, d, ps, b = 8, 64, 64, 32
    worst = check_paged_cell(card, gen, heads=heads)
    worst.update(check_paged_stream(card, gen, heads=heads))
    timed = {}
    for name, kernel, lens, pps, dtype in (
            ("cell bf16", pa.paged_decode_cell, SMOKE_LENGTHS, 16, torch.bfloat16),
            ("stream bf16", pa.paged_decode_stream, RAGGED_LENGTHS, 32, torch.bfloat16),
            ("stream int8", pa.paged_decode_stream, RAGGED_LENGTHS, 32, torch.int8)):
        w = heads * pa.head_stride(d, heads)
        n_pages = b * pps
        if dtype == torch.int8:
            pools = pa.PagedPools(*(torch.randint(-127, 128, (n_pages, ps, w), generator=gen,
                                                  device=dev, dtype=torch.int8)
                                    for _ in range(2)),
                                  (torch.rand((n_pages, ps, pa.LANE), generator=gen,
                                              device=dev) * 0.02 + 1e-3).to(torch.bfloat16))
        else:
            pools = pa.PagedPools(*(torch.randn((n_pages, ps, w), generator=gen,
                                                device=dev).to(dtype) for _ in range(2)))
        q = torch.randn((b, heads, d), generator=gen, device=dev) * d ** -0.5
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        base = (torch.arange(b, device=dev) * pps).to(torch.int32)
        kw = dict(page_size=ps, pages_per_slot=pps, kv_heads=heads, head_dim=d)
        extra = {"max_length": max(lens)} if kernel is pa.paged_decode_cell else {}
        n_bytes = paged_bytes(lens, b, heads, heads, d, w, dtype, append=False)
        timed[name] = {
            "ms": time_ms(lambda: kernel(q, pools, lengths, base, **kw, **extra), 50),
            "plain_ms": time_ms(lambda: pa.decode_reference(q, pools, lengths, base, **kw), 3),
            "library_ms": None, "l2": "warm",
            **bound(n_bytes, sum(lens) * heads * d * 4,
                    {torch.int8: "int8", torch.bfloat16: "bf16"}[dtype])}
        del pools
    attention = {f"{dtype}[32,1024,8,8,64]": attention_case(32, 1024, 8, 8, 64, dtype, False,
                                                            True, gen)
                 for dtype in (torch.bfloat16, torch.float32)}
    torch.cuda.empty_cache()
    out = {"paged_o_max_abs_err": worst, "paged_timed": timed, "causal_attention": attention}
    emit({"phase": "mesh_local_kernels", "heads": heads, **out, "card": card})
    return out


# ---- phase 9's training parts ---------------------------------------------
#
# tp=2 and dp=2 at tv2o-medium's full width and depth, f32 masters made on
# the CPU from phase 6's step-0 seed (the same weights on every rank, in
# the parent and in tools/train_mesh_cpu_reading_torch.py), step 0 on
# TRAIN_MESH_ROWS x TRAIN_MESH_EVENTS events against one device; the tp=2
# shard's attention shapes: the event net at 8 heads x 64, the token net at
# 2 heads x 256.

TRAIN_MESH_ROWS, TRAIN_MESH_EVENTS = 2, 512
STEP0_SAMPLE = ("net.layers.0.self_attn.q_proj.weight", "net.layers.11.self_attn.k_proj.weight",
                "net.layers.5.mlp.down_proj.weight", "net_token.layers.0.self_attn.v_proj.weight",
                "net.embed_tokens.weight", "lm_head.weight")
# Step 0 on the mesh against one device: the loss's relative difference and
# the sampled gradients' largest difference relative to each leaf's largest
# value.  Each bound is 1.6x a reading of two correct computations, rounded
# up (PERF.md section 6, training on the mesh):
# - the same comparison on the CPU (tools/train_mesh_cpu_reading_torch.py:
#   tp=2 and dp=2 as gloo ranks on the CPU against one CPU process, the
#   same weights and batch, on the card's machine; the larger of the two
#   meshes' readings).  f32: loss 1.15e-7 (dp=2; one f32 step of a loss
#   near 8.3; tp=2 0), so 1.6x is rounded up to two such steps; gradients
#   1.008e-6.  bf16 compute: loss 2.79e-5, gradients 7.65e-3 (tp=2), of the
#   order of phase 6's bf16 step-0 reading of the kernels against plain
#   attention (6.2e-3).
# - f32 gradients: the card's f32 rounding is larger than the CPU's (tp=2
#   2.87e-6, dp=2 2.25e-6 in runs AU, AV: a bound of 1.6x the CPU's 1.008e-6
#   failed), so, as TP_DEEP_TOLS, the yardstick is one device's step on the
#   CPU against the same on the card (``f32_step0_cpu_vs_card``, printed by
#   every run: 3.76e-6 in run AV).
TRAIN_MESH_TOLS = {"float32": {"loss_rel": 2.3e-7, "grad_rel": 6.1e-6},
                   "bfloat16": {"loss_rel": 4.5e-5, "grad_rel": 1.3e-2}}
TRAIN_MESH_STEPS = 3  # on a fixed batch, bf16 compute: the loss falls


def train_mesh_batches(batch_of):
    """Step 0's global microbatch ``[ROWS, EVENTS, T]`` and the fixed batch
    of the timed steps ``[2 microbatches, ROWS, EVENTS, T]``."""
    step0 = batch_of(TRAIN_MESH_ROWS, TRAIN_MESH_EVENTS, 0)
    fixed = batch_of(2 * TRAIN_MESH_ROWS, TRAIN_MESH_EVENTS, 1).reshape(
        2, TRAIN_MESH_ROWS, TRAIN_MESH_EVENTS, -1)
    return step0, fixed


def train_mesh_params(device):
    """tv2o-medium's f32 masters from phase 6's step-0 seed, made on the
    CPU (the same numbers on every rank and machine), on ``device``."""
    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.train import trainer as tr

    config = MIDIModelConfig.from_name("tv2o-medium")
    params = tr.init_params(config, seed=3, device="cpu")
    return config, {n: p.to(device) for n, p in params.items()}


def step0_sample(params, config, rows, dtype, mesh=None):
    """One microbatch's loss and the gradients of ``STEP0_SAMPLE``, summed
    over the data group and gathered over the model group as the step
    does: (loss, {name: f32 CPU tensor})."""
    from midi_model_tpu_torch.train import trainer as tr
    from midi_model_tpu_torch.train.sharding import gather_params

    p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    loss, metrics = tr.loss_fn(p, config, rows, dtype, mesh=mesh)
    loss.backward()
    sample = {n: p[n].grad for n in STEP0_SAMPLE}
    if mesh is not None:
        tr.sum_over(sample, mesh.data_group)
        sample = gather_params(sample, mesh)
    return float(metrics["loss"].detach()), {n: g.float().cpu() for n, g in sample.items()}


def step0_errors(mine, ref) -> dict:
    """The loss's relative difference and each sampled gradient's largest
    difference relative to the leaf's largest value."""
    loss, grads = mine
    loss_r, grads_r = ref
    per_leaf = {n: float((grads[n] - grads_r[n]).abs().max() / grads_r[n].abs().max())
                for n in grads_r}
    return {"loss": loss, "loss_ref": loss_r, "loss_rel": abs(loss - loss_r) / abs(loss_r),
            "grad_rel": max(per_leaf.values()), "grad_rel_by_leaf": per_leaf}


@contextlib.contextmanager
def timed_collectives(stats: dict):
    """``torch.distributed.all_reduce`` and ``all_gather`` replaced by
    stand-ins that synchronize the card before and after each call and
    append its seconds to ``stats[name]``."""
    import torch
    import torch.distributed as dist

    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def wrap(name):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            stats.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed

    for name in real:
        setattr(dist, name, wrap(name))
    try:
        yield stats
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def mesh_attention_train(card: str) -> None:
    """The causal attention backward kernels at a tp=2 shard's training
    shapes against their plain versions, at phase 2's bounds: the event net
    [2, 2047, 8, 64] and the token net [4094, 8, 2, 256] (two heads: the
    Dh-256 packed-row grids ran at four before), bf16 and f32, each timed
    warm beside SDPA's backward with its bound (``attention_bwd_case``);
    and the forward at the token net's shard shape, bf16 and f32, beside
    SDPA (``attention_case``; the event net's is phase 9's [32, 1024, 8, 64])."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4323)
    out = {}
    for b, s, h, dh in ((2, 2047, 8, 64), (4094, 8, 2, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            out[f"{dtype}[{b},{s},{h},{h},{dh}]"] = attention_bwd_case(b, s, h, h, dh, dtype,
                                                                        gen, timed=True)
    forward = {f"{dtype}[4094,8,2,2,256]": attention_case(4094, 8, 2, 2, 256, dtype, False,
                                                          True, gen)
               for dtype in (torch.bfloat16, torch.float32)}
    emit({"phase": "mesh_attention_train", "backward": out, "forward": forward, "card": card})


def mesh_train_part(mesh, batches, ref_path: str, what: str) -> dict:
    """One rank's share of a tp=2 or dp=2 training run at tv2o-medium:
    step 0 in f32 and bf16 on this data shard's rows (the first rank holds
    it against one device's, ``ref_path``); then ``TRAIN_MESH_STEPS`` bf16
    steps on the fixed batch, the first with every all-reduce and
    all-gather timed, the others timed whole; peak memory; the launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.train import trainer as tr
    from midi_model_tpu_torch.train.sharding import shard_params

    config, params = train_mesh_params(mesh.device)
    local = shard_params(params, mesh)
    del params
    step0, fixed = batches
    n = TRAIN_MESH_ROWS // mesh.dp
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    first = dist.get_rank() == 0
    ref = torch.load(ref_path, weights_only=True) if first else None
    out = {"step0": {}}
    _build.LAUNCHES.clear()
    for dtype in (torch.float32, torch.bfloat16):
        mine = step0_sample(local, config, step0[rows], dtype, mesh)
        if first:
            out["step0"][str(dtype).split(".")[-1]] = step0_errors(mine, ref[str(dtype)])
        del mine
    torch.cuda.empty_cache()
    optimizer = tr.make_optimizer(lr=3e-4, warmup_steps=0, total_steps=1000)
    state = tr.init_train_state(local, optimizer)
    del local
    step = tr.make_train_step(config, optimizer, accum_steps=2, compute_dtype=torch.bfloat16,
                              mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    losses, times, stats = [], [], {}
    for i in range(TRAIN_MESH_STEPS):
        with timed_collectives(stats) if i == 0 else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, fixed[:, rows])
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
    out.update({
        "what": what, "losses": losses, "ms_per_step": float(np.mean(times[1:])) * 1e3,
        "ms_per_step_runs": [t * 1e3 for t in times],
        "collectives_per_step": {k: len(v) for k, v in stats.items()},
        "collective_ms_per_step": {k: float(np.sum(v)) * 1e3 for k, v in stats.items()},
        "collective_mean_ms": {k: float(np.mean(v)) * 1e3 for k, v in stats.items()},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": dict(_build.LAUNCHES)})
    if first:
        emit({"phase": "mesh_rank_run", "run": f"train {what}", "ms_per_step": out["ms_per_step"],
              "losses": losses})
    del state, step
    torch.cuda.empty_cache()
    return out


def mesh_tp_part(mesh, tp_queue) -> dict:
    """One rank's share of the tp=2 runs at tv2o-large's full width and
    depth (8 heads and an MLP of 2048 a rank), each of ``TP_RUNS``:
    greedy ``generate_tp`` at bs=32, a 256-event prompt and ``TP_EVENTS`` new events;
    the hidden after the prefill and after a greedy ``TP_CHUNK``-event
    decode chunk, with every all-reduce of the chunk timed; and the greedy
    tp batcher over ``tp_queue`` (eos disabled)."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.sampling import build_mask_table, mask_tensors
    from midi_model_tpu_torch.sampling.sharded import (decode_events_tp, generate_tp,
                                                       prefill_tp, tp_shard_params)
    from midi_model_tpu_torch.serve import ContinuousBatcher

    config = MIDIModelConfig.from_name("tv2o-large")
    tok = config.tokenizer
    prompt = mesh_prompt(tok, 32, 256)
    out = {"generate": {}, "batcher": {}}
    for dtype in ("float32", "bfloat16"):
        full = init_model(config, seed=MESH_SEED, dtype=getattr(torch, dtype),
                          device=mesh.device)
        local = tp_shard_params(full, mesh)
        runs = {name: run for name, run in TP_RUNS.items() if run[0] == dtype}
        for name, (_, _, kv_int8, _, _) in runs.items():
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            rows = generate_tp(local, config, mesh, prompt=prompt, batch_size=32,
                               max_len=256 + TP_EVENTS, greedy=True, kv_int8=kv_int8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out["generate"][name] = {"rows": rows, "wall_s": wall,
                                     "launches": dict(_build.LAUNCHES)}
            if mesh.model_rank == 0:
                emit({"phase": "mesh_rank_run", "run": f"generate_tp {name}", "wall_s": wall})
            state = prefill_tp(local, config, prompt, 256 + TP_EVENTS, mesh, kv_int8=kv_int8)
            run = out["generate"][name]
            run["hidden_prefill"] = state.hidden.float().cpu().numpy()
            # every all-reduce of the chunk timed alone
            stats = {}
            with timed_collectives(stats):
                masks = mask_tensors(build_mask_table(tok), mesh.device)
                state, chunk, n_done = decode_events_tp(local, config, state, masks, TP_CHUNK,
                                                        1.0, 0.98, 20, None, mesh, greedy=True)
            run["hidden_chunk"] = state.hidden.float().cpu().numpy()
            run["chunk_rows"] = chunk.cpu().numpy()
            run["all_reduce"] = {"per_event": len(stats["all_reduce"]) / n_done,
                                 "mean_ms": float(np.mean(stats["all_reduce"])) * 1e3,
                                 "bytes": 32 * config.n_embd * local.dtype.itemsize,
                                 "dtype": dtype}
            del state
        del local
        for name, (_, _, kv_int8, _, n_requests) in runs.items():
            batcher = ContinuousBatcher(full, config, n_slots=32, max_seq=2048, chunk=16,
                                        seed=11, disable_eos=True, greedy=True,
                                        kv_int8=kv_int8, mesh=mesh)
            require(batcher.path == "split" and batcher.config.net.num_heads == 8,
                    f"tp batcher: path {batcher.path}, {batcher.config.net.num_heads} heads")
            out["batcher"][name] = drive_queue(batcher, tp_queue[:n_requests])
            if mesh.model_rank == 0:
                emit({"phase": "mesh_rank_run", "run": f"tp batcher {name}",
                      "wall_s": out["batcher"][name]["wall_s"]})
            del batcher
            torch.cuda.empty_cache()
        del full
        torch.cuda.empty_cache()
    return out


def mesh_dp_part(mesh, dp_queue) -> dict:
    """One rank's share of the dp=2 runs at tv2o-medium's full width and
    depth, bf16: ``generate_dp`` at bs=32 (16 a rank, the event loop), 64
    events sampled; the dp batcher at 32 slots (16 a rank, the ragged event
    loop) over ``dp_queue``, sampled, eos disabled."""
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.sampling.sharded import generate_dp
    from midi_model_tpu_torch.serve import ContinuousBatcher

    config = MIDIModelConfig.from_name("tv2o-medium")
    model = init_model(config, seed=MESH_SEED + 1, dtype=torch.bfloat16, device=mesh.device)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    rows = generate_dp(model, config, mesh, batch_size=32, max_len=65, seed=3)
    torch.cuda.synchronize()
    out = {"generate": {"rows": rows, "wall_s": time.perf_counter() - t0,
                        "launches": dict(_build.LAUNCHES)}}
    batcher = ContinuousBatcher(model, config, n_slots=32, max_seq=2048, chunk=16, seed=11,
                                disable_eos=True, mesh=mesh)
    require(batcher.path == "event_loop", f"dp batcher path {batcher.path}")
    out["batcher"] = drive_queue(batcher, dp_queue)
    if mesh.data_rank == 0:
        emit({"phase": "mesh_rank_run", "run": "dp", "generate_dp_wall_s":
              out["generate"]["wall_s"], "batcher_wall_s": out["batcher"]["wall_s"]})
    return out


def mesh_rank_pair(out_dir: str, card: str, tp_queue, dp_queue, train_batches) -> None:
    """Rank program of the two-rank runs (gloo, both on cuda:0): rank 0's
    local kernel checks (serving's and the training backward's), the tp=2
    part and the tp=2 training part, then the dp=2 part and the dp=2
    training part; each rank pickles its results to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from midi_model_tpu_torch.parallel import make_mesh

    cuda_settings()
    rank = dist.get_rank()
    mesh = make_mesh(tp=2)
    ref_path = str(Path(out_dir) / "train_ref.pt")
    res = {}
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    if rank == 0:
        res["kernels"] = mesh_local_kernels(card)
        mesh_attention_train(card)
    dist.barrier(group=mesh.host_group)
    lap("kernels")
    res["tp"] = mesh_tp_part(mesh, tp_queue)
    torch.cuda.empty_cache()
    lap("tp")
    res["train_tp"] = mesh_train_part(mesh, train_batches, ref_path, "tp=2")
    lap("train_tp")
    dp_mesh = make_mesh(dp=2)
    res["dp"] = mesh_dp_part(dp_mesh, dp_queue)
    torch.cuda.empty_cache()
    lap("dp")
    res["train_dp"] = mesh_train_part(dp_mesh, train_batches, ref_path, "dp=2")
    lap("train_dp")
    if rank == 0:
        emit({"phase": "mesh_rank_parts", "seconds": seconds})
    (Path(out_dir) / f"pair{rank}.pkl").write_bytes(pickle.dumps(res))


DPTP_DIMS = dict(n_layer=4, n_head=16, n_embd=1024, n_inner=4096)  # tv2o-medium's width


def mesh_rank_dptp(out_dir: str, queue, cli_argv) -> None:
    """Rank program of the four-rank runs (gloo, all on cuda:0): the dp=2 x
    tp=2 batcher at tv2o-medium's width at 4 layers, f32, 8 slots (4 a data
    shard), greedy; then the training CLI at ``--dp 2 --tp 2`` on the same
    process group (``cli_argv``)."""
    import torch
    import torch.distributed as dist

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.parallel import make_mesh
    from midi_model_tpu_torch.serve import ContinuousBatcher
    from midi_model_tpu_torch.train import cli

    cuda_settings()
    mesh = make_mesh(dp=2, tp=2)
    config = MIDIModelConfig.get_config("v2", True, **DPTP_DIMS)
    model = init_model(config, seed=MESH_SEED + 2, dtype=torch.float32, device=mesh.device)
    batcher = ContinuousBatcher(model, config, n_slots=8, max_seq=1024, chunk=16, seed=11,
                                disable_eos=True, greedy=True, mesh=mesh)
    run = drive_queue(batcher, queue)
    del batcher, model
    torch.cuda.empty_cache()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    state = cli.main(cli_argv)
    torch.cuda.synchronize()
    run["cli"] = {"wall_s": time.perf_counter() - t0, "step": state.step,
                  "launches": dict(_build.LAUNCHES),
                  "local_lm_head": list(state.params["lm_head.weight"].shape)}
    (Path(out_dir) / f"dptp{dist.get_rank()}.pkl").write_bytes(pickle.dumps(run))


def mesh_rank_nccl(out_dir: str) -> None:
    """Rank program of the NCCL run, one rank a card (one card: world size
    1): ``make_mesh(tp=world)``, an NCCL all-reduce over the default group
    and ``all_reduce_sum`` over the model group, then ``generate_tp`` beside
    ``generate`` (tv2o-medium, f32; sampled at world size 1, greedy on
    several cards).  Rank 0 pickles the results to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.parallel import all_reduce_sum, make_mesh
    from midi_model_tpu_torch.sampling import generate
    from midi_model_tpu_torch.sampling.sharded import generate_tp, tp_shard_params

    cuda_settings()
    world = dist.get_world_size()
    mesh = make_mesh(tp=world)
    base = torch.arange(1024, dtype=torch.float32)
    x = torch.arange(1024, dtype=torch.float32, device=mesh.device)
    dist.all_reduce(x)  # over the default group: NCCL
    y = x.clone()
    same = all_reduce_sum(y, mesh.model_group) is y
    config = MIDIModelConfig.from_name("tv2o-medium")
    model = init_model(config, seed=MESH_SEED + 3, dtype=torch.float32, device=mesh.device)
    kw = dict(batch_size=8, max_len=33, seed=4, greedy=world > 1)
    _build.LAUNCHES.clear()
    rows_tp = generate_tp(tp_shard_params(model, mesh), config, mesh, **kw)
    launches = dict(_build.LAUNCHES)
    rows = generate(model, config, **kw)
    res = {"backend": dist.get_backend(), "world": world, "devices": str(mesh.device),
           "all_reduce_ok": bool(torch.equal(x.cpu(), base * world)
                                 and torch.equal(y.cpu(), base * world * world)),
           "all_reduce_sum_in_place": same, "rows_tp": rows_tp, "rows": rows,
           "launches": launches}
    if dist.get_rank() == 0:
        (Path(out_dir) / "nccl0.pkl").write_bytes(pickle.dumps(res))


def single_device_train(batches, ref_path: Path) -> dict:
    """One device's share of the training parts: step 0 in f32 and bf16 on
    the whole microbatch (saved to ``ref_path`` for the first rank), then
    the timed bf16 steps on the fixed batch: losses, ms a step, peak
    memory."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.train import trainer as tr

    config, params = train_mesh_params("cuda")
    step0, fixed = batches
    ref = {str(dtype): step0_sample(params, config, step0, dtype)
           for dtype in (torch.float32, torch.bfloat16)}
    torch.save(ref, ref_path)
    # the f32 yardstick: the same step on the CPU (the plain versions)
    # against the card's
    t0 = time.perf_counter()
    cpu_config, cpu_params = train_mesh_params("cpu")
    cpu_vs_card = step0_errors(step0_sample(cpu_params, cpu_config, step0, torch.float32),
                               ref[str(torch.float32)])
    cpu_vs_card["seconds"] = time.perf_counter() - t0
    del cpu_params, ref
    optimizer = tr.make_optimizer(lr=3e-4, warmup_steps=0, total_steps=1000)
    state = tr.init_train_state(params, optimizer)
    del params
    step = tr.make_train_step(config, optimizer, accum_steps=2, compute_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, fixed)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    torch.cuda.empty_cache()
    return {"losses": losses, "ms_per_step": float(np.mean(times[1:])) * 1e3,
            "ms_per_step_runs": [t * 1e3 for t in times], "peak_memory_gb": peak,
            "f32_step0_cpu_vs_card": cpu_vs_card}


def mesh_cli_argv(work: Path, out: Path) -> list:
    """The mesh CLI run's arguments (the mesh flags added by the caller):
    tv2o-medium on phase 6's corpus, bf16 compute, bs 2 x acc 2 x 512
    events, 3 steps and one validation (its checkpoint and export) at the
    last; no loader processes (the ranks are daemons) and no example
    pieces."""
    return ["--data", str(work / "corpus"), "--config", "tv2o-medium", "--data-val-split", "2",
            "--max-len", "512", "--batch-size-train", "2", "--acc-grad", "2",
            "--batch-size-val", "1", "--max-step", "3", "--val-step", "3", "--warmup-step", "2",
            "--workers-train", "0", "--gen-example-interval", "0", "--out-dir", str(out)]


def check_mesh_cli(card: str, runs, cli_argv, out: Path) -> None:
    """The ``--dp 2 --tp 2`` CLI run: every rank took 3 steps on its shard
    (half the vocab's head), the checkpoint and the export hold the
    single-device layout, and ``--resume`` on one device takes the 4th
    step from that checkpoint."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.interop import load_state_dict
    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import MIDINet
    from midi_model_tpu_torch.train import cli

    config = MIDIModelConfig.from_name("tv2o-medium")
    layout = {n: tuple(p.shape) for n, p in MIDINet(config, device="meta").named_parameters()}
    vocab = config.tokenizer.vocab_size
    require(all(r["cli"]["step"] == 3 and r["cli"]["local_lm_head"] == [vocab // 2, 1024]
                for r in runs), f"mesh CLI: {[r['cli'] for r in runs]}")
    ckpt = out / "checkpoints"
    saved = torch.load(ckpt / "step_3.pt", map_location="cpu", weights_only=True)
    require(all({n: tuple(t.shape) for n, t in saved[k].items()} == layout
                for k in ("params", "mu", "nu")) and saved["opt_count"] == 3,
            "mesh CLI: the checkpoint is not in the single-device layout")
    exported = load_state_dict(str(ckpt / "model.safetensors"))
    require(all(np.array_equal(exported[n], p.numpy()) for n, p in saved["params"].items()),
            "mesh CLI: the export differs from the checkpoint")
    logged = [json.loads(line) for line in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in logged if "train/loss" in r]
    val = [r["val/loss"] for r in logged if "val/loss" in r]
    require(len(losses) == 3 and all(np.isfinite(losses + val)) and len(val) == 1,
            f"mesh CLI: logged {logged}")
    del saved, exported
    t0 = time.perf_counter()
    resumed = cli.main(cli_argv + ["--resume", "1", "--max-step", "4", "--val-step", "0"])
    resume_s = time.perf_counter() - t0
    require(resumed.step == 4 and resumed.opt_state.count == 4
            and tuple(resumed.params["lm_head.weight"].shape) == layout["lm_head.weight"],
            f"mesh CLI: --resume on one device reached step {resumed.step}")
    emit({"phase": "mesh_train_cli", "dp": 2, "tp": 2, "ranks_on_one_card": 4,
          "train_losses": losses, "val_loss": val[0], "wall_s": runs[0]["cli"]["wall_s"],
          "launches_rank0": runs[0]["cli"]["launches"], "resume_one_device_s": resume_s,
          "card": card})
    del resumed
    torch.cuda.empty_cache()


@contextlib.contextmanager
def group_of_one():
    """A gloo process group of this process alone.  Given to one device's
    split path as ``tp_group`` it makes every all-reduce a no-op and takes
    the tp run's token path (the token-row kernel), so that a row that parts
    from the tp run's parts through the tp sums alone."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def timed_generate(model, config, prompt, **kw):
    """Single-device ``generate`` on the split path at bs=32, ``TP_EVENTS`` events
    after ``prompt``: its rows and wall seconds."""
    import torch

    from midi_model_tpu_torch.sampling import generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = generate(model, config, prompt=prompt, batch_size=32, max_len=256 + TP_EVENTS,
                    fused=False, **kw)
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def single_device_hidden(model, config, prompt, kv_int8: bool, at: str,
                         tp_group=None) -> dict:
    """One device's hidden after the prefill of ``prompt`` (``at``
    "prefill") or after a greedy ``TP_CHUNK``-event decode chunk on the
    split path, with the chunk's rows ("chunk"), as ``mesh_tp_part`` takes
    them on the tp ranks."""
    from midi_model_tpu_torch.sampling import (build_mask_table, decode_events,
                                               mask_tensors, prefill)

    state = prefill(model, config, prompt, 256 + TP_EVENTS, kv_int8=kv_int8)
    if at == "prefill":
        return {"hidden_prefill": state.hidden.float().cpu().numpy()}
    masks = mask_tensors(build_mask_table(config.tokenizer), state.hidden.device)
    state, chunk, _ = decode_events(model, config, state, masks, TP_CHUNK, 1.0, 0.98, 20,
                                    None, greedy=True, fused=False, tp_group=tp_group)
    return {"hidden_chunk": state.hidden.float().cpu().numpy(),
            "chunk_rows": chunk.cpu().numpy()}


def deep_hidden_errors(name: str, model, config, prompt, tp_run, card_run) -> dict:
    """The tp run's hidden after 24 layers against one device's, where
    ``TP_RUNS[name]`` takes it: the largest difference over the rows (after
    the chunk: the rows whose chunk agrees) and on rows 0-1, the bounded
    one; beside them the yardstick, the single-device stack on the CPU (the
    plain versions, on a copy of the weights) against the card on rows
    0-1."""
    import numpy as np

    from midi_model_tpu_torch.models.midinet import MIDINet

    _, _, kv_int8, at, _ = TP_RUNS[name]
    t0 = time.perf_counter()
    cpu_model = MIDINet(config, dtype=model.dtype, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_run = single_device_hidden(cpu_model, config, prompt[:2], kv_int8, at)
    del cpu_model
    key = f"hidden_{at}"
    agree = np.arange(len(prompt))
    cpu_agree = np.arange(2)
    if at == "chunk":
        same = lambda a, b: (a == b).all(axis=(1, 2))  # noqa: E731
        agree = np.nonzero(same(tp_run["chunk_rows"], card_run["chunk_rows"]))[0]
        cpu_agree = np.nonzero(same(cpu_run["chunk_rows"], card_run["chunk_rows"][:2]))[0]
        require(set(agree) >= {0, 1} and len(cpu_agree) == 2,
                f"{name}: the chunk's rows 0-1 part (tp agrees on {agree.tolist()}, "
                f"the CPU on {cpu_agree.tolist()})")
    err = np.abs(tp_run[key][agree] - card_run[key][agree]).max(axis=1)
    return {"hidden_at": at, "hidden_rows_compared": len(agree),
            "hidden_max_abs_err": float(err.max()),
            "hidden_max_abs_err_rows_0_1": float(err[:2].max()),
            "bound": TP_DEEP_TOLS[name],
            "cpu_vs_card": float(np.abs(cpu_run[key] - card_run[key][:2]).max()),
            "cpu_vs_card_s": time.perf_counter() - t0}


def phase_mesh(card: str) -> dict:
    """Phase 9: the mesh paths (``parallel``, ``sampling.sharded``, the
    batcher's ``mesh``), each rank a process on a card (all on the one
    card where the machine has one):

    1. two gloo ranks: rank 0's kernels at the tp shard's shapes
       (``mesh_local_kernels``); tp=2 at tv2o-large's full width and depth
       (``mesh_tp_part``) against one device on the split path with the tp
       run's token path (``group_of_one``), greedy, on f32 weights with f32
       and with int8 pools and on bf16 weights: ``generate_tp`` against
       ``generate`` and the tp batcher (16 requests)
       against the single-device batcher, the rows that differ counted and
       each parting
       at a near-tie (``TIE_GAPS``); the hidden after 24 layers on rows 0-1
       within ``TP_DEEP_TOLS`` (after the prefill; int8 pools: after a
       decode chunk); the grammar on every row; readings: each rank's
       launches, events/s, the all-reduces per event (48 expected) and
       their mean ms.  Then dp=2 at tv2o-medium (``mesh_dp_part``):
       ``generate_dp`` shard i equal to single-device ``generate`` on its
       rows with ``shard_seed(3, i)``, the dp batcher's records equal to the
       single-device batcher's.  Training on the same ranks: rank 0's
       attention kernels at the tp shard's training shapes
       (``mesh_attention_train``);
       the tp=2 and dp=2 training parts (``mesh_train_part``) against one
       device's (``single_device_train``, run here first);
    2. four gloo ranks: the greedy dp=2 x tp=2 batcher at tv2o-medium's
       width and 4 layers, every rank admitting, records equal to the
       single-device batcher's but for near-ties; then the training CLI at
       ``--dp 2 --tp 2`` and ``--resume`` on one device
       (``check_mesh_cli``);
    3. NCCL: on one card one rank, ``make_mesh()``, an NCCL all-reduce,
       ``generate_tp`` at tp=1 equal to ``generate``; on a machine with
       several cards two ranks on two cards, tp=2, greedy rows equal to
       ``generate``'s but for near-ties.

    Returns rank 0's launches over the mesh runs, by kernel."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.parallel import spawn
    from midi_model_tpu_torch.sampling import build_mask_table, generate
    from midi_model_tpu_torch.sampling.sharded import shard_seed
    from midi_model_tpu_torch.serve import ContinuousBatcher

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "mesh_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    large = MIDIModelConfig.from_name("tv2o-large")
    medium = MIDIModelConfig.from_name("tv2o-medium")
    tok = large.tokenizer
    # budgets of 16-32 keep the tp runs' event steps few (each takes 48
    # all-reduces between processes)
    tp_queue = request_queue(tok, np.random.default_rng(90), 48, (16, 513), (16, 33))
    dp_queue = request_queue(tok, np.random.default_rng(91), 48, (16, 513), (32, 129))
    dptp_queue = request_queue(tok, np.random.default_rng(92), 12, (16, 129), (16, 49))
    # the training parts: one device's step 0 (the reference the first rank
    # reads) and its timed steps on the same batches
    _, work, batch_of = training_corpus()
    train_batches = train_mesh_batches(batch_of)
    single = single_device_train(train_batches, out_dir / "train_ref.pt")
    emit({"phase": "mesh_train_single_device", **single, "card": card})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spawn(mesh_rank_pair, 2, (str(out_dir), card, tp_queue, dp_queue, train_batches),
          timeout_s=720, **MESH_LIMITS)
    pair_s = time.perf_counter() - t0
    emit({"phase": "mesh_pair_processes", "seconds": pair_s})
    pair = [pickle.loads((out_dir / f"pair{r}.pkl").read_bytes()) for r in range(2)]
    for part in ("tp", "dp"):
        a, b = (pickle.dumps(p[part]["batcher"]["records"] if part == "dp" else
                             {n: r["records"] for n, r in p[part]["batcher"].items()})
                for p in pair)
        require(a == b, f"{part}: the ranks' batcher records differ")
    tp0, dp0 = pair[0]["tp"], pair[0]["dp"]
    launches = {}

    def count(run):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v

    # 1a-b. tp generate and the tp batcher against one device, whose split
    # path takes the tp run's token path
    prompt = mesh_prompt(tok, 32, 256)
    for dtype in ("float32", "bfloat16"):
        model = init_model(large, seed=MESH_SEED, dtype=getattr(torch, dtype), device="cuda")
        runs = {name: run for name, run in TP_RUNS.items() if run[0] == dtype}
        for name, (_, kind, kv_int8, at, _) in runs.items():
            run = tp0["generate"][name]
            count(run)
            with group_of_one() as one:
                ref, ref_s = timed_generate(model, large, prompt, greedy=True,
                                            kv_int8=kv_int8, tp_group=one)
                card_run = single_device_hidden(model, large, prompt, kv_int8, at, one)
            rows = run["rows"]
            require(pickle.dumps(rows) == pickle.dumps(pair[1]["tp"]["generate"][name]["rows"]),
                    f"generate_tp {name}: the ranks' rows differ")
            require(rows.shape == ref.shape, f"generate_tp {name}: {rows.shape} vs {ref.shape}")
            check_rows(rows[:, 256:], build_mask_table(tok), tok, f"generate_tp {name}")
            differ = [i for i in range(32) if (rows[i] != ref[i]).any()]
            entry = {"rows_differing": len(differ), "events_per_s": 32 * TP_EVENTS / run["wall_s"],
                     "single_device_events_per_s": 32 * TP_EVENTS / ref_s,
                     "launches_rank0": run["launches"],
                     "launches_rank1": pair[1]["tp"]["generate"][name]["launches"],
                     "tie_gaps": [first_tie_gap(model, prompt[i], ref[i, 256:], rows[i, 256:])
                                  for i in differ], "tie_gap_bound": TIE_GAPS[kind],
                     **deep_hidden_errors(name, model, large, prompt, run, card_run),
                     "all_reduce": run["all_reduce"]}
            emit({"phase": "mesh_tp", "run": f"generate_tp {name}", **entry, "card": card})
            cell = "paged_decode_int8" if kv_int8 else "paged_decode"
            require(all(run["launches"].get(k, 0) for k in (
                "token_row", cell, "paged_decode_stream", "causal_attention"))
                and not {"fused_step", "fused_step_int8", "event_loop", "sampler"}
                & set(run["launches"]), f"generate_tp {name} launches {run['launches']}")
            require(all(abs(g) <= TIE_GAPS[kind] for g in entry["tie_gaps"]),
                    f"generate_tp {name}: tie gaps {entry['tie_gaps']}")
            require(entry["hidden_max_abs_err_rows_0_1"] <= entry["bound"],
                    f"generate_tp {name}: hidden err {entry['hidden_max_abs_err_rows_0_1']}")
        for name, (_, kind, kv_int8, _, n_requests) in runs.items():
            run = tp0["batcher"][name]
            queue = tp_queue[:n_requests]
            count(run)
            ref = drive_queue(ContinuousBatcher(model, large, n_slots=32, max_seq=2048,
                                                chunk=16, seed=11, disable_eos=True,
                                                greedy=True, kv_int8=kv_int8, fused=False),
                              queue)
            check_queue(run["records"], queue, tok, True, f"tp batcher {name}")
            differ = differing(run["records"], ref["records"])
            entry = {"requests_differing": len(differ), "events": run["events"],
                     "events_per_s": run["events"] / run["wall_s"],
                     "single_device_events_per_s": ref["events"] / ref["wall_s"],
                     "single_device_path": ref["path"], "launches_rank0": run["launches"],
                     "launches_rank1": pair[1]["tp"]["batcher"][name]["launches"],
                     "tie_gaps": [first_tie_gap(model, queue[i][0], ref["records"][i][0],
                                                run["records"][i][0]) for i in differ],
                     "tie_gap_bound": TIE_GAPS[kind]}
            emit({"phase": "mesh_tp", "run": f"tp batcher {name}", **entry, "card": card})
            require(run["launches"].get("token_row", 0) and run["launches"].get(
                "paged_decode_stream", 0) and not {"fused_step", "fused_step_int8",
                                                    "event_loop_ragged"} & set(run["launches"]),
                    f"tp batcher {name} launches {run['launches']}")
            require(all(abs(g) <= TIE_GAPS[kind] for g in entry["tie_gaps"]),
                    f"tp batcher {name}: tie gaps {entry['tie_gaps']}")
        del model
        torch.cuda.empty_cache()
    emit({"phase": "mesh_tp_all_reduce", "config": "tv2o-large", "tp": 2,
          **tp0["generate"]["bf16"]["all_reduce"], "card": card})

    # 1c. dp=2 against one device
    require(pickle.dumps(dp0["generate"]["rows"]) == pickle.dumps(pair[1]["dp"]["generate"]["rows"]),
            "generate_dp: the ranks' rows differ")
    model = init_model(medium, seed=MESH_SEED + 1, dtype=torch.bfloat16, device="cuda")
    rows = dp0["generate"]["rows"]
    count(dp0["generate"])
    for i in range(2):
        ref = generate(model, medium, batch_size=16, max_len=65, seed=shard_seed(3, i))
        mine = rows[16 * i:16 * (i + 1)]
        require(bool((mine[:, :ref.shape[1]] == ref).all())
                and bool((mine[:, ref.shape[1]:] == tok.pad_id).all()),
                f"generate_dp shard {i} differs from generate with its seed")
    require(dp0["generate"]["launches"].get("event_loop", 0) > 0,
            f"generate_dp launches {dp0['generate']['launches']}")
    ref = drive_queue(ContinuousBatcher(model, medium, n_slots=32, max_seq=2048, chunk=16,
                                        seed=11, disable_eos=True), dp_queue)
    run = dp0["batcher"]
    count(run)
    check_queue(run["records"], dp_queue, tok, True, "dp batcher")
    differ = differing(run["records"], ref["records"])
    require(not differ and run["launches"].get("event_loop_ragged", 0) > 0,
            f"dp batcher: requests {differ} differ; launches {run['launches']}")
    emit({"phase": "mesh_dp", "config": "tv2o-medium", "dp": 2, "ranks_on_one_card": 2,
          "generate_dp_events_per_s": 32 * 64 / dp0["generate"]["wall_s"],
          "generate_dp_launches_rank0": dp0["generate"]["launches"],
          "batcher_events_per_s": run["events"] / run["wall_s"],
          "single_device_batcher_events_per_s": ref["events"] / ref["wall_s"],
          "batcher_launches_rank0": run["launches"],
          "batcher_launches_rank1": pair[1]["dp"]["batcher"]["launches"],
          "pair_processes_s": pair_s, "card": card})
    del model
    torch.cuda.empty_cache()

    # 1d. the tp=2 and dp=2 training parts
    step0_misses = []
    for part in ("train_tp", "train_dp"):
        runs = [p[part] for p in pair]
        run = runs[0]
        count(run)
        emit({"phase": "mesh_train", "run": run["what"], "config": "tv2o-medium",
              "ranks_on_one_card": 2, "step0": run["step0"], "bounds": TRAIN_MESH_TOLS,
              "losses": run["losses"], "ms_per_step": run["ms_per_step"],
              "ms_per_step_runs": run["ms_per_step_runs"],
              "single_device_ms_per_step": single["ms_per_step"],
              "collectives_per_step": run["collectives_per_step"],
              "collective_ms_per_step": run["collective_ms_per_step"],
              "collective_mean_ms": run["collective_mean_ms"],
              "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in runs],
              "launches_rank0": run["launches"], "card": card})
        require(runs[0]["losses"] == runs[1]["losses"],
                f"{part}: the ranks' losses differ: {[r['losses'] for r in runs]}")
        require(all(np.isfinite(run["losses"])) and run["losses"][-1] < run["losses"][0],
                f"{part}: the loss did not fall: {run['losses']}")
        # a backward a layer a microbatch: step 0 in two dtypes, then the
        # steps' two microbatches each
        want = (medium.net.num_layers + medium.net_token.num_layers) * 2 * (1 + TRAIN_MESH_STEPS)
        require(run["launches"].get("causal_attention_bwd", 0) == want
                and run["launches"].get("causal_attention", 0) == want,
                f"{part}: launches {run['launches']} (expected {want} of each)")
        # held to the bounds once every path has run: a miss still fails the
        # phase, after its readings
        for dtype, errs in run["step0"].items():
            tol = TRAIN_MESH_TOLS[dtype]
            if errs["loss_rel"] > tol["loss_rel"] or errs["grad_rel"] > tol["grad_rel"]:
                step0_misses.append(f"{part} step 0 {dtype}: {errs}, bounds {tol}")

    # 2. dp=2 x tp=2 on four ranks: the batcher, then the training CLI
    cli_out = work / "mesh_run"
    cli_argv = mesh_cli_argv(work, cli_out)
    t0 = time.perf_counter()
    spawn(mesh_rank_dptp, 4, (str(out_dir), dptp_queue, cli_argv + ["--dp", "2", "--tp", "2"]),
          timeout_s=480, **MESH_LIMITS)
    dptp_s = time.perf_counter() - t0
    runs = [pickle.loads((out_dir / f"dptp{r}.pkl").read_bytes()) for r in range(4)]
    require(all(pickle.dumps(r["records"]) == pickle.dumps(runs[0]["records"]) for r in runs),
            "dp x tp: the ranks' records differ")
    count(runs[0])
    config = MIDIModelConfig.get_config("v2", True, **DPTP_DIMS)
    model = init_model(config, seed=MESH_SEED + 2, dtype=torch.float32, device="cuda")
    ref = drive_queue(ContinuousBatcher(model, config, n_slots=8, max_seq=1024, chunk=16,
                                        seed=11, disable_eos=True, greedy=True), dptp_queue)
    check_queue(runs[0]["records"], dptp_queue, tok, True, "dp x tp batcher")
    differ = differing(runs[0]["records"], ref["records"])
    gaps = [first_tie_gap(model, dptp_queue[i][0], ref["records"][i][0], runs[0]["records"][i][0])
            for i in differ]
    emit({"phase": "mesh_dp_tp", "dims": DPTP_DIMS, "dp": 2, "tp": 2, "ranks_on_one_card": 4,
          "requests": len(dptp_queue), "events": runs[0]["events"],
          "requests_differing": len(differ), "tie_gaps": gaps,
          "events_per_s": runs[0]["events"] / runs[0]["wall_s"],
          "launches_by_rank": [r["launches"] for r in runs], "processes_s": dptp_s,
          "card": card})
    require(all(abs(g) <= TIE_GAPS["f32"] for g in gaps),
            f"dp x tp batcher: requests {differ} differ, tie gaps {gaps}")
    require(all(r["launches"].get("causal_attention", 0) for r in runs),
            f"dp x tp: a rank admitted nothing: {[r['launches'] for r in runs]}")
    del model
    torch.cuda.empty_cache()
    check_mesh_cli(card, runs, cli_argv, cli_out)
    count(runs[0]["cli"])
    shutil.rmtree(work, ignore_errors=True)

    # 3. NCCL: one rank on one card; one rank a card, tp over two, where
    # the machine has several
    t0 = time.perf_counter()
    world = min(2, torch.cuda.device_count())
    spawn(mesh_rank_nccl, world, (str(out_dir),), backend="nccl", timeout_s=180,
          **MESH_LIMITS)
    res = pickle.loads((out_dir / "nccl0.pkl").read_bytes())
    rows_tp, rows = res.pop("rows_tp"), res.pop("rows")
    differ = [i for i in range(len(rows)) if rows_tp.shape != rows.shape
              or (rows_tp[i] != rows[i]).any()]
    gaps = []
    if differ and world > 1 and rows_tp.shape == rows.shape:
        model = init_model(medium, seed=MESH_SEED + 3, dtype=torch.float32, device="cuda")
        gaps = [first_tie_gap(model, rows[i, :1], rows[i, 1:], rows_tp[i, 1:])  # bos prompt
                for i in differ]
        del model
    require(res["backend"] == "nccl" and res["world"] == world and res["all_reduce_ok"]
            and res["all_reduce_sum_in_place"] and res["launches"].get("token_row", 0) > 0
            and (not differ if world == 1 else len(gaps) == len(differ)
                 and all(abs(g) <= TIE_GAPS["f32"] for g in gaps)),
            f"NCCL world {world}: {res}, rows differing {differ}, tie gaps {gaps}")
    count(res)
    emit({"phase": "mesh_nccl", **res, "rows_differing": len(differ), "tie_gaps": gaps,
          "processes_s": time.perf_counter() - t0, "card": card})
    shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "card": card})
    require(not step0_misses, "; ".join(step0_misses))
    return launches


SOURCES = {
    "sampler": ("midi_model_tpu_torch/csrc/sampler.cu", "midi_model_tpu/ops/sampler.py:39"),
    "paged_decode": ("midi_model_tpu_torch/csrc/paged_decode.cu",
                     "midi_model_tpu/ops/paged_allheads.py:212"),
    "causal_attention": ("midi_model_tpu_torch/csrc/causal_attention.cu",
                         "midi_model_tpu/ops/attention.py:145"),
    "token_row": ("midi_model_tpu_torch/csrc/token_loop.cu",
                  "midi_model_tpu/ops/token_loop.py:107"),
    "fused_step": ("midi_model_tpu_torch/csrc/fused_step.cu",
                   "midi_model_tpu/ops/fused_step.py:81"),
    "event_loop": ("midi_model_tpu_torch/csrc/event_loop.cu",
                   "midi_model_tpu/ops/event_loop.py:92"),
    "paged_decode_int8": ("midi_model_tpu_torch/csrc/paged_decode.cu",
                          "midi_model_tpu/ops/paged_allheads.py:212"),
    "paged_decode_stream": ("midi_model_tpu_torch/csrc/paged_decode_stream.cu",
                            "midi_model_tpu/ops/paged_allheads.py:408"),
    "event_loop_ragged": ("midi_model_tpu_torch/csrc/event_loop.cu",
                          "midi_model_tpu/ops/event_loop.py:1162"),
    "fused_step_int8": ("midi_model_tpu_torch/csrc/fused_step.cu",
                        "midi_model_tpu/ops/fused_step.py:81"),
    "causal_attention_bwd": ("midi_model_tpu_torch/csrc/causal_attention_bwd.cu",
                             "midi_model_tpu/ops/attention.py:131"),
    # the f32 forms (3xTF32 tensor-core products at head_dim 64), launched
    # by the f32 timed training loop
    "causal_attention_f32": ("midi_model_tpu_torch/csrc/causal_attention.cu",
                             "midi_model_tpu/ops/attention.py:145"),
    "causal_attention_bwd_f32": ("midi_model_tpu_torch/csrc/causal_attention_bwd.cu",
                                 "midi_model_tpu/ops/attention.py:131"),
}


def main(argv=()) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--attention", action="store_true",
                        help="build with ptxas' register and spill report, run the causal "
                        "attention forward and backward checks of phase 2, and stop "
                        "(no result line)")
    parser.add_argument("--sampler", action="store_true",
                        help="build with ptxas' register and spill report, run the sampler "
                        "checks and timings of phase 2 and the token row check (the sample "
                        "phase at top_k 20 and 128), and stop (no result line)")
    parser.add_argument("--paged", action="store_true",
                        help="build with ptxas' register and spill report, run the paged "
                        "decode checks of phase 2 and their cold-cache timings, and stop "
                        "(no result line)")
    parser.add_argument("--step", action="store_true",
                        help="build with ptxas' register and spill report, run the token-row, "
                        "whole-step and event-loop checks of phase 2 (the token row at "
                        "tv2o-medium's and granite's widths, the whole step with its phase "
                        "clock and timed cases, its int8 form, the aligned and ragged "
                        "loops) with the digests of their outputs, and stop (no result line)")
    parser.add_argument("--api", action="store_true",
                        help="build, write a run directory with one step of phase 6's CLI, "
                        "run phase 7 (the MIDIModel facade, LoRA, remat policies, publish, "
                        "export) on it, and stop (no result line)")
    parser.add_argument("--app", action="store_true",
                        help="build, run phase 8 (the native extensions, preprocessing, the "
                        "serving app batched and aligned, the demo) on random bf16 weights, "
                        "and stop (no result line)")
    parser.add_argument("--ssm", action="store_true",
                        help="build, hold the Mamba-2 kernels (ssm_scan, ssm_step) to their "
                        "plain versions at granite-4.0-h-micro's widths with times, and stop "
                        "(no result line)")
    parser.add_argument("--mesh", action="store_true",
                        help="build, run phase 9 (the mesh paths, serving and training: tp=2, "
                        "dp=2 and dp x tp as processes on the card over gloo, the training "
                        "CLI at --dp 2 --tp 2, one NCCL rank), and stop (no result line)")
    args = parser.parse_args(list(argv))
    if not (ROOT / "midi_model_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the midi_model_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # fp32 comparisons below mean full fp32: no TF32 in matmuls or convolutions;
    # bf16 products of the plain versions reduce in f32, as the kernels do
    cuda_settings()

    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    phase_build(card, verbose=args.attention or args.paged or args.sampler or args.step)
    if args.app:
        phase_app(card)
        return 0
    if args.mesh:
        phase_mesh(card)
        return 0
    if args.ssm:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        check_ssm(card, gen)
        return 0
    if args.api:
        from midi_model_tpu_torch.train import cli

        corpus = training_corpus()
        cli.main(train_cli_argv(corpus[1], corpus[1] / "run", 1)
                 + ["--gen-example-interval", "0"])
        phase_api(card, corpus)
        shutil.rmtree(corpus[1], ignore_errors=True)
        return 0
    if args.sampler:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        check_sampler(card, gen)
        check_token_row(card, gen)
        return 0
    if args.step:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        with decode_digests():
            check_token_row(card, gen)
            check_fused_step(card, gen)
            check_fused_step_int8(card, gen)
            check_event_loop(card, gen)
            check_event_loop_ragged(card, gen)
        return 0
    if args.paged:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        worst = check_paged_cell(card, gen)
        worst.update(check_paged_stream(card, gen))
        emit({"phase": "paged_rows", **paged_kernel_rows(time_paged_cell_vs_stream(card),
                                                         worst)})
        return 0
    if args.attention:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        check_attention(card, gen)
        check_attention_bwd(card, gen)
        config, work, batch_of = training_corpus()
        check_train_step0(card, config, batch_of)
        for dtype in (torch.bfloat16, torch.float32):
            timed_training(card, config, batch_of, dtype)
        shutil.rmtree(work, ignore_errors=True)
        return 0
    results = phase_kernels(card)
    phase_oracle(card)
    launches = phase_slice(card)
    # each batcher path's launches from its own run
    counts, _ = phase_batcher(card, kv_int8=False)
    launches["event_loop_ragged"] = counts["event_loop_ragged"]
    _, pair_rate = phase_batcher(card, kv_int8=True)  # the int8 default: the per-event pair
    counts, split_rate = phase_batcher(card, kv_int8=True, fused=False)
    launches["paged_decode_stream"] = counts["paged_decode_stream"]
    emit({"phase": "batcher_int8_default", "default": "pair",
          "full_occupancy_events_per_s": {"pair": pair_rate, "split": split_rate},
          "card": card})
    require(pair_rate > split_rate, f"the int8 batcher's default (the per-event pair, "
            f"{pair_rate} events/s) is not the faster path (split scan {split_rate})")
    corpus = training_corpus()
    launches.update(phase_train(card, corpus))
    api_launches = phase_api(card, corpus)
    app_launches = phase_app(card, corpus[1] / "run" / "checkpoints" / "model.safetensors")
    shutil.rmtree(corpus[1], ignore_errors=True)
    mesh_launches = phase_mesh(card)
    require("jax" not in sys.modules, "jax was imported")
    require(not any(m == "midi_model_tpu" or m.startswith("midi_model_tpu.")
                    for m in sys.modules), "the JAX package was imported")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "api_launches": api_launches.get(name, 0),
         "app_launches": app_launches.get(name, 0),
         "mesh_launches": mesh_launches.get(name, 0),
         **{k: results[name][k] for k in keys}}
        for name, (src, replaces) in SOURCES.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
