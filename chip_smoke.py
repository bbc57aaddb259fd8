#!/usr/bin/env python3
"""Drive the PyTorch port (``midi_model_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the script
exits non-zero:

1. build   — compile the port's CUDA kernels from ``midi_model_tpu_torch/csrc``;
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes, with times for both: sampler, paged
             decode, causal attention, the token row (f32 rows identical;
             bf16 greedy rows identical up to near-ties), the fused
             event-net step (f32 within 1e-4; bf16 within 3e-2 after one
             layer, 0.125 after 12; rows outside the append bit-identical)
             and the 8-event loop (f32 rows identical and within 1e-4; bf16
             rows against the per-event kernel pair);
3. oracle  — fp32 tv2o-medium weights rebuilt from
             ``tests/golden/reference_oracle.pkl``: logits within atol 2e-4 /
             rtol 2e-3 and greedy rows token-identical to the golden (the
             split path: fp32 weights);
4. slice   — bf16 tv2o-medium with random weights: ``generate`` at bs=32 on
             the default (fused) path — 8-event launches and a per-event
             tail — and on the split path, each with the launch counts of
             its kernels read from its own run; a timed prefill + 256-event
             ``decode_events`` run with eos disabled on three paths in turns
             (8-event launches, per-event fused launches, split), with kernel
             launches per event; and ``generate`` from a random 1024-event
             prompt; every generated row must obey the grammar mask tables.

Then the kernel summary line, the card's ``nvidia-smi`` name and power limit,
and the result line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script fails before any result.
"""

from __future__ import annotations

import json
import pickle
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
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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


def phase_build(card: str):
    from midi_model_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(path.relative_to(ROOT)), "card": card})


def phase_kernels(card: str) -> dict:
    import torch

    from midi_model_tpu_torch.ops import attention as at
    from midi_model_tpu_torch.ops import paged_allheads as pa
    from midi_model_tpu_torch.ops import sampler as sp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = {}

    # -- sampler at [32, 3406]: peaked, flat, tied and masked rows, per-row knobs
    b, v, k_cap = 32, 3406, 128
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
    mismatches = 0
    for _ in range(16):
        g = -torch.log(torch.empty((b, k_cap), device=dev).exponential_(generator=gen))
        ids = sp.sample_top_p_k(probs, top_p, top_k, g)
        ref = sp.sample_top_p_k_reference(probs, top_p, top_k, g)
        torch.cuda.synchronize()
        mismatches += int((ids != ref).sum())
    require(mismatches == 0, f"sampler: {mismatches} ids differ from the plain version")
    top_p_main = torch.full((b,), 0.98, device=dev)
    top_k_main = torch.full((b,), 20, dtype=torch.int32, device=dev)
    main_probs = torch.softmax(torch.randn((b, v), generator=gen, device=dev) * 3, -1)
    results["sampler"] = {
        "max_abs_err": float(mismatches),
        "ms": time_ms(lambda: sp.sample_top_p_k(main_probs, top_p_main, top_k_main, g), 200),
        "plain_ms": time_ms(lambda: sp.sample_top_p_k_reference(
            main_probs, top_p_main, top_k_main, g), 5),
    }
    emit({"phase": "kernel", "name": "sampler", "shape": [b, v],
          "ids_identical": True, **results["sampler"], "card": card})

    # -- paged decode with append, B=32, 16 heads x 64, pages of 64 rows; the
    # main path's MHA in f32 and bf16 pools, and GQA (append as a second launch)
    b, h, d, ps, pps, n_layers = 32, 16, 64, 64, 16, 2
    cap = ps * pps
    lengths = torch.tensor([0, 1, 63, 64, 1000, cap, 65, 127, 128, 500, 999, 2] * 3,
                           dtype=torch.int32, device=dev)[:b]
    li = 1
    base = ((li * b + torch.arange(b, device=dev)) * pps).to(torch.int32)
    write_pos = lengths.clamp(0, cap - 1)
    wpages = base + write_pos // ps
    woffs = write_pos % ps
    worst = {}
    for dtype, hkv in ((torch.float32, 16), (torch.bfloat16, 16), (torch.float32, 4)):
        w = hkv * pa.head_stride(d, hkv)
        k_pool = torch.randn((n_layers * b * pps, ps, w), generator=gen, device=dev).to(dtype)
        v_pool = torch.randn((n_layers * b * pps, ps, w), generator=gen, device=dev).to(dtype)
        q = torch.randn((b, h, d), generator=gen, device=dev) * d ** -0.5
        new_k = torch.randn((b, w), generator=gen, device=dev).to(dtype)
        new_v = torch.randn((b, w), generator=gen, device=dev).to(dtype)
        kern = pa.PagedPools(k_pool.clone(), v_pool.clone())
        plain = pa.PagedPools(k_pool.clone(), v_pool.clone())
        kw = dict(page_size=ps, pages_per_slot=pps, kv_heads=hkv, head_dim=d)
        o, m, l, kern = pa.paged_attention_stats(
            q, kern, lengths, base, (new_k, new_v, wpages, woffs), **kw)
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
        err = float((o[live] - o_r[live]).abs().max())
        worst[f"{dtype} kv_heads={hkv}"] = err
        if dtype == torch.bfloat16:  # the main path's pool dtype
            results["paged_decode"] = {
                "ms": time_ms(lambda: pa.paged_attention_stats(
                    q, kern, lengths, base, (new_k, new_v, wpages, woffs), **kw), 200),
                "plain_ms": time_ms(lambda: (
                    pa.decode_reference(q, plain, lengths, base, **kw),
                    pa.kv_append(plain, new_k, new_v, wpages, woffs)), 20),
            }
    results["paged_decode"]["max_abs_err"] = max(worst.values())
    emit({"phase": "kernel", "name": "paged_decode", "batch": b, "heads": h,
          "head_dim": d, "lengths": lengths.tolist(), "o_max_abs_err": worst,
          **results["paged_decode"], "card": card})

    # -- causal attention: the prefill shape [4, 2048, 16, 64] bf16, a ragged
    # f32 case with a strided q, and the token net's heads [2, 9, 4, 256]
    errs = {}
    f32_tol = dict(atol=5e-5, rtol=1e-4)  # f32 rounding only
    # bf16: the plain version rounds the probabilities to bf16 before P.V,
    # the kernel keeps them in f32 — one bf16 step at magnitude 2-4
    bf16_tol = dict(atol=2e-2, rtol=2e-2)
    for (b, s, h, dh, dtype, tol) in ((2, 300, 16, 64, torch.float32, f32_tol),
                                      (2, 9, 4, 256, torch.float32, f32_tol),
                                      (4, 2048, 16, 64, torch.bfloat16, bf16_tol)):
        wide = torch.randn((b, s, h, 2 * dh), generator=gen, device=dev).to(dtype)
        q = wide[..., :dh]  # strided: no copy
        k = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
        out = at.causal_attention(q, k, v)
        ref = at.attention_reference(q, k, v, at.causal_bias(s, dev))
        torch.cuda.synchronize()
        require(torch.allclose(out.float(), ref.float(), **tol),
                f"causal attention {dtype} [{b},{s},{h},{dh}]")
        errs[f"{dtype}[{b},{s},{h},{dh}]"] = float((out.float() - ref.float()).abs().max())
        if dtype == torch.bfloat16:
            results["causal_attention"] = {
                "max_abs_err": max(errs.values()),
                "ms": time_ms(lambda: at.causal_attention(q, k, v), 10),
                "plain_ms": time_ms(lambda: at.attention_reference(
                    q, k, v, at.causal_bias(s, dev)), 3),
            }
    emit({"phase": "kernel", "name": "causal_attention", "max_abs_err_by_case": errs,
          **results["causal_attention"], "card": card})
    results["token_row"] = check_token_row(card, gen)
    results["fused_step"] = check_fused_step(card, gen)
    results["event_loop"] = check_event_loop(card, gen)
    return results


def check_token_row(card: str, gen) -> dict:
    """The token-row kernel against its plain version at tv2o-medium, B=32:
    f32 rows identical (greedy and sampled, over per-row knobs, allow-plane
    and forced-pad rows); bf16 greedy rows identical, sampled share printed."""
    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
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
                          *args, greedy=False), 3)}
        del model
        torch.cuda.empty_cache()
    result = {"max_abs_err": 1.0 - min(out["torch.float32"].values()), **timing}
    emit({"phase": "kernel", "name": "token_row", "batch": b,
          "identical_row_share": out, "bf16_greedy_tie_logit_gaps": gaps, **result,
          "card": card})
    return result


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
    plain version on the card is printed beside it."""
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import fused_step as fs
    from midi_model_tpu_torch.ops import paged_allheads as pa

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
                result = {"ms": time_ms(lambda: fs.fused_decode_step(
                              fused, net, x, kern, index, active, **kw), 20),
                          "plain_ms": time_ms(lambda: fs.fused_decode_step_reference(
                              fused, net, x, plain, index, active, **kw), 3)}
            del kern, plain
        errs[str(dtype)] = case
        del full, k0, v0
        torch.cuda.empty_cache()
    result["max_abs_err"] = errs["torch.float32"][f"{config.net.num_layers}_layers"]["hidden"]
    emit({"phase": "kernel", "name": "fused_step", "batch": b, "index": index.tolist(),
          "max_abs_err_by_dtype": errs, **result, "card": card})
    return result


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
                                          10)}
            del pools
        del model, fused, k0, v0
        torch.cuda.empty_cache()
    result["max_abs_err"] = max(c["hidden"] for c in out["torch.float32"].values())
    emit({"phase": "kernel", "name": "event_loop", "batch": b, "events": n_ev,
          "cached_rows": len0, "by_case": out, **result, "card": card})
    return result


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


def device_profile(run, n_events: int) -> dict:
    """torch.profiler over ``run()`` (decoding ``n_events``): device kernel
    launches (every kernel on the card, not only ours), device time and wall
    time per event, the device's busy share, and the top kernels."""
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
    return {"launches_per_event": sum(c for _, _, c in kernels) / n_events,
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
    # event-loop launches and a 3-event per-event tail), then the split path
    launches = {}
    for fused, kernels in ((None, ("event_loop", "token_row", "fused_step",
                                   "causal_attention")),
                           (False, ("sampler", "paged_decode", "causal_attention"))):
        _build.LAUNCHES.clear()
        rows = generate(model, config, batch_size=batch, max_len=260, temp=1.0,
                        top_p=0.98, top_k=20, seed=0, fused=fused)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        path = "fused (default)" if fused is None else "split"
        require(rows.shape[0] == batch and 1 < rows.shape[1] <= 260, f"rows {rows.shape}")
        check_rows(rows[:, 1:], table, tokenizer, f"generate bs=32, {path} path")
        for name in kernels:
            require(counts.get(name, 0) > 0, f"{path} path never launched {name}: {counts}")
        if fused is None:
            require("sampler" not in counts and "paged_decode" not in counts,
                    f"the default bf16 path took the split path: {counts}")
        launches = {**counts, **launches}
        emit({"phase": "slice_generate", "path": path, "batch": batch,
              "rows_shape": list(rows.shape), "launches": counts, "card": card})

    # bench.py-shaped timed run: prefill + 256 events, eos disabled, three
    # paths in turns (8-event launches, per-event fused launches, split; twice)
    n_events = 256
    prompt = normalize_prompt(tokenizer, None, batch)
    table_ne = build_mask_table(tokenizer, disable_eos=True)
    masks = mask_tensors(table_ne, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)

    # per_event: the fused path with one token-row and one whole-step launch
    # per event (blocks of one event: no event-loop launch)
    paths = {"event_loop": (True, el.EVENTS_PER_LAUNCH), "per_event": (True, 1),
             "split": (False, el.EVENTS_PER_LAUNCH)}

    def run(n, path, state=None):
        fused, el.EVENTS_PER_LAUNCH = paths[path]
        if state is None:
            state = prefill(model, config, prompt, 1 + n_events)
        return decode_events(model, config, state, masks, n, 1.0, 0.98, 20, gen,
                             fused=fused)

    timed = {path: [] for path in paths}
    per_event = {}
    for path in paths:
        run(8, path)  # warm-up
    for path in list(paths) * 2:
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
}


def main() -> int:
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    phase_build(card)
    results = phase_kernels(card)
    phase_oracle(card)
    launches = phase_slice(card)
    require("jax" not in sys.modules, "jax was imported")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **results[name]}
        for name, (src, replaces) in SOURCES.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
