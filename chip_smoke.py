#!/usr/bin/env python3
"""Drive the PyTorch port (``midi_model_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the script
exits non-zero:

1. build   — compile the port's CUDA kernels from ``midi_model_tpu_torch/csrc``;
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes, with times for both;
3. oracle  — fp32 tv2o-medium weights rebuilt from
             ``tests/golden/reference_oracle.pkl``: logits within atol 2e-4 /
             rtol 2e-3 and greedy rows token-identical to the golden;
4. slice   — bf16 tv2o-medium with random weights: ``generate`` at bs=32
             (launch counts of every kernel read from this run), a timed
             prefill + 256-event ``decode_events`` run with eos disabled, and
             ``generate`` from a random 1024-event prompt; every generated row
             must obey the grammar mask tables.

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
    return results


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


def phase_slice(card: str) -> dict:
    import numpy as np
    import torch

    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.sampling import (build_mask_table, decode_events,
                                               generate, mask_tensors,
                                               normalize_prompt, prefill)

    dev = torch.device("cuda")
    config = MIDIModelConfig.from_name("tv2o-medium")
    tokenizer = config.tokenizer
    model = init_model(config, seed=0, dtype=torch.bfloat16, device=dev)
    table = build_mask_table(tokenizer)
    batch = 32

    # the main path, once, with the launch counts read from exactly this run
    _build.LAUNCHES.clear()
    rows = generate(model, config, batch_size=batch, max_len=257, temp=1.0,
                    top_p=0.98, top_k=20, seed=0)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    require(rows.shape[0] == batch and 1 < rows.shape[1] <= 257, f"rows {rows.shape}")
    check_rows(rows[:, 1:], table, tokenizer, "generate bs=32")
    for name in ("sampler", "paged_decode", "causal_attention"):
        require(launches.get(name, 0) > 0, f"main path never launched {name}: {launches}")
    emit({"phase": "slice_generate", "batch": batch, "rows_shape": list(rows.shape),
          "launches": launches, "card": card})

    # bench.py-shaped timed run: prefill + 256 events, eos disabled
    n_events = 256
    prompt = normalize_prompt(tokenizer, None, batch)
    table_ne = build_mask_table(tokenizer, disable_eos=True)
    masks = mask_tensors(table_ne, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)

    def run(n):
        state = prefill(model, config, prompt, 1 + n_events)
        state, rows, n_done = decode_events(model, config, state, masks, n,
                                            1.0, 0.98, 20, gen)
        return rows, n_done

    run(8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows_t, n_done = run(n_events)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(n_done == n_events, f"timed run decoded {n_done} of {n_events}")
    check_rows(rows_t.cpu().numpy(), table_ne, tokenizer, "timed run")
    events_s = batch * n_events / dt
    emit({"phase": "slice_timed", "batch": batch, "events": n_events,
          "seconds": dt, "events_per_s": events_s, "card": card})

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
    # fp32 comparisons below mean full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
