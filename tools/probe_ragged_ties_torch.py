#!/usr/bin/env python3
"""Near-ties in the ragged event loop's f32 sampled check, on one CUDA card.

    python3 tools/probe_ragged_ties_torch.py [--seeds 40]

``chip_smoke.py``'s ``check_event_loop_ragged`` wants the ragged event
loop's f32 sampled rows identical to its plain version's on the inputs
phase 2's generator stream gives it.  This probe runs that case under
other streams: phase 2's with the sampler check drawing all its cases from
the shared generator (an earlier form of that check did), phase 2's as it
stands, and fresh generators seeded 1..N.  For each slot whose rows differ
it prints, at the first differing token, what both sides see through the
plain token net from the event hidden (the input at event 0; after e
events the plain version's and the kernel's): f32 logits and their
distance to f64 products, the probabilities, the rank order, the kept
sets at the top_p / top_k boundary, the Gumbel draw, the probability gap
of the two ids in f32 ulps, and the sampler kernel's draw on the plain
probabilities.  One JSON line a stream, then a summary line.
"""
import argparse
import inspect
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

from midi_model_tpu_torch.models import MIDIModelConfig  # noqa: E402
from midi_model_tpu_torch.models.midinet import init_model  # noqa: E402
from midi_model_tpu_torch.ops import _build  # noqa: E402
from midi_model_tpu_torch.ops import event_loop as el  # noqa: E402
from midi_model_tpu_torch.ops import fused_step as fs  # noqa: E402
from midi_model_tpu_torch.ops import paged_allheads as pa  # noqa: E402
from midi_model_tpu_torch.ops import sampler as sp  # noqa: E402
from midi_model_tpu_torch.sampling import (build_allow_vector, build_mask_table,  # noqa: E402
                                           mask_tensors, slot_gumbel)

dev = torch.device("cuda")
config = MIDIModelConfig.from_name("tv2o-medium")
tok = config.tokenizer
MODEL = FUSED = None  # the check's f32 model (seed 4), made in main()


def inputs(gen):
    """check_event_loop_ragged's inputs, drawing from gen as it does (f32 part)."""
    b, n_ev, ps, pps = 32, 8, 64, 32
    cap = ps * pps
    masks = mask_tensors(build_mask_table(tok), dev)
    rng = np.random.default_rng(3)
    index = torch.as_tensor(rng.integers(1, cap - 100, b), dtype=torch.int32, device=dev)
    index[3] = cap - 3
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
    allow[3, tok.eos_id] = False
    allow = torch.as_tensor(allow, device=dev)
    seeds = torch.as_tensor(rng.integers(0, 2 ** 32, b), device=dev)
    noise = slot_gumbel(seeds, index[None, :] + torch.arange(n_ev, device=dev)[:, None], 8)
    hidden = torch.randn((b, config.n_embd), generator=gen, device=dev)
    w = config.net.num_heads * config.net.head_dim
    n_pages = config.net.num_layers * b * pps
    k0 = torch.randn((n_pages, ps, w), generator=gen, device=dev)
    v0 = torch.randn((n_pages, ps, w), generator=gen, device=dev)
    return dict(index=index, active=active, masks=masks, temp=temp, top_p=top_p, top_k=top_k,
                noise=noise, allow=allow, hidden=hidden, k0=k0, v0=v0, b=b, n_ev=n_ev, ps=ps,
                pps=pps)


def keep_sets(probs, top_p, top_k):
    """The plain sampler's rank order, exclusive running mass (f32 rank by
    rank) and kept flags, for one row of probs (f32 tensor on the card)."""
    order = torch.argsort(-probs, stable=True)
    p = probs[order]
    texcl = torch.cumsum(torch.cat([torch.zeros(1, device=p.device), p[:-1]]), 0)
    # the running mass as the plain version sums it: sequentially in f32
    run = np.full(len(p), np.inf, np.float32)
    acc = np.float32(0)
    pn = p.cpu().numpy()
    for i in range(min(len(p), 200)):
        run[i] = acc
        acc = np.float32(acc + pn[i])
    kept = (run <= top_p) & (np.arange(len(p)) < top_k)
    return order.cpu().numpy(), pn, run, kept


def diagnose(x, rows, rows_r, slot, event, step, hid, label):
    """Logits, probabilities, kept sets and draws at (slot, event, step) from
    the event hidden ``hid`` [1, D] through the plain token net (f32 on the
    card, f64 products on the host)."""
    pref = rows_r[event, slot, :step]
    temp = float(x["temp"][slot])
    with torch.no_grad():
        logits32, _ = MODEL.forward_token(hid, pref[None] if step else None)
        l32 = logits32[0, -1]
        # f64 on the host: the token net and head in double
        net64 = type(MODEL.net_token)(config.net_token, dtype=torch.float64, device="cpu")
        net64.load_state_dict({k: v.double().cpu() for k, v in MODEL.net_token.state_dict().items()})
        head = MODEL.lm_head.weight.double().cpu()
        seq = [hid.double().cpu()[:, None, :]]
        if step:
            seq.append(net64.embed_tokens(pref[None].long().cpu()))
        h64, _ = net64(torch.cat(seq, 1))
        l64 = (h64[0, -1] @ head.T)
    first = x["masks"].first
    steps = x["masks"].steps
    e_off = int(rows_r[event, slot, 0]) - (tok.eos_id + 1)
    mask = (first if step == 0 else steps[e_off, step]) & x["allow"][slot]
    probs32 = torch.softmax(l32 / temp, -1) * mask
    probs64 = torch.softmax(l64 / temp, -1) * mask.cpu()
    top_p, top_k = float(x["top_p"][slot]), int(x["top_k"][slot])
    g = x["noise"][event, step * x["b"] + slot]
    order, pn, run, kept = keep_sets(probs32, top_p, top_k)
    order64 = torch.argsort(-probs64, stable=True).numpy()
    p64 = probs64.numpy()[order64]
    run64 = np.concatenate([[0.0], np.cumsum(p64)[:-1]])
    kept64 = (run64 <= top_p) & (np.arange(len(p64)) < top_k)
    n_kept = int(kept.sum())
    score = np.where(kept[:128], np.log(pn[:128]) + g.cpu().numpy()[:128], -np.inf)
    plain_draw = int(order[int(np.argmax(score))])
    # the sampler kernel on the same plain probs
    k_id = int(sp.sample_top_p_k(probs32[None].contiguous(), x["top_p"][slot:slot + 1],
                                 x["top_k"][slot:slot + 1], g[None].contiguous())[0])
    kern_id, ref_id = int(rows[event, slot, step]), int(rows_r[event, slot, step])
    rank_of = {int(t): i for i, t in enumerate(order[:256])}
    kr = rank_of.get(kern_id)
    pr = rank_of.get(ref_id)
    ulp = float(np.spacing(np.float32(max(float(probs32[kern_id]), float(probs32[ref_id])))))
    out = {
        "hidden_from": label, "plain_id_rank_in_plain_order": pr,
        "prob_gap_in_ulps": float(probs32[kern_id] - probs32[ref_id]) / ulp,
        "ids_kept_f32": None if kr is None or pr is None else [bool(kept[kr]), bool(kept[pr])],
        "slot": slot, "event": event, "step": step, "temp": temp, "top_p": top_p, "top_k": top_k,
        "kernel_id": kern_id, "plain_id": ref_id, "plain_draw_recomputed": plain_draw,
        "sampler_kernel_on_plain_probs": k_id,
        "allowed_ids": int(mask.sum()), "n_kept_f32": n_kept, "n_kept_f64": int(kept64.sum()),
        "kept_f32_equals_kept_f64_ids": sorted(order[kept].tolist()) == sorted(order64[kept64].tolist()),
        "top_p_minus_running_mass_at_boundary": [float(top_p - run[i]) for i in range(max(n_kept - 2, 0), min(n_kept + 2, len(run)))],
        "boundary_ranks": list(range(max(n_kept - 2, 0), min(n_kept + 2, len(run)))),
        "boundary_ids": [int(order[i]) for i in range(max(n_kept - 2, 0), min(n_kept + 2, len(run)))],
        "running_mass_f32_minus_f64_at_boundary": [float(run[i] - run64[i]) for i in range(max(n_kept - 2, 0), min(n_kept + 2, len(run)))],
        "kernel_id_rank_in_plain_order": kr,
        "kernel_id_running_mass": None if kr is None else float(run[kr]),
        "kernel_id_score": None if kr is None else float(np.log(pn[kr]) + float(g[kr])),
        "plain_id_score": float(score.max()),
        "logit_f32_minus_f64_max": float((l32.double().cpu() - l64).abs().max()),
        "prob_gap_kernel_vs_plain_id": float(probs32[kern_id] - probs32[ref_id]),
        "probs_top8": [float(v) for v in pn[:8]],
        "logits_at_kernel_and_plain_ids_f32": [float(l32[kern_id]), float(l32[ref_id])],
        "logits_at_kernel_and_plain_ids_f64": [float(l64[kern_id]), float(l64[ref_id])],
    }
    return out


def ragged_f32(x, label):
    kw = dict(page_size=x["ps"], pages_per_slot=x["pps"])
    args = (MODEL, config, FUSED, x["hidden"])

    def run(kernel, n):
        knobs = (x["index"], x["active"], x["masks"], x["temp"], x["top_p"], x["top_k"],
                 x["noise"][:n].contiguous(), x["allow"])
        fn = el.decode_event_block_ragged if kernel else el.decode_event_block_ragged_reference
        return fn(*args, pa.PagedPools(x["k0"].clone(), x["v0"].clone()), *knobs, greedy=False,
                  n_events=n, **kw)

    rows, _, _ = run(True, x["n_ev"])
    rows_r, _, _ = run(False, x["n_ev"])
    torch.cuda.synchronize()
    diff = (rows != rows_r).nonzero().tolist()
    firsts = {}
    for e, s, j in diff:
        if s not in firsts or (e, j) < firsts[s]:
            firsts[s] = (e, j)
    out = {"stream": label, "differing_slots": {s: list(v) for s, v in sorted(firsts.items())}}
    diags = []
    for s, (e, j) in sorted(firsts.items()):
        if e == 0:
            diags.append(diagnose(x, rows, rows_r, s, e, j, x["hidden"][s:s + 1], "input"))
            continue
        # the hidden after e events: the kernel's and the plain version's
        # (the slot's rows agree before event e)
        _, h_k, _ = run(True, e)
        _, h_p, _ = run(False, e)
        for h, name in ((h_p, "plain after %d events" % e), (h_k, "kernel after %d events" % e)):
            diags.append(diagnose(x, rows, rows_r, s, e, j, h[s:s + 1].float(), name))
        diags[-1]["hidden_kernel_minus_plain_max"] = float((h_k[s] - h_p[s]).abs().max())
    out["diagnoses"] = diags
    print(json.dumps(out), flush=True)
    return out


def phase2_stream(card: str, first_sampler_form: bool) -> torch.Generator:
    """The generator after phase 2's checks before the ragged event loop's,
    in their order; with ``first_sampler_form`` the sampler check draws all
    its cases from the shared generator."""
    check_sampler = cs.check_sampler
    if first_sampler_form:
        ns = dict(cs.__dict__)
        exec(inspect.getsource(cs.check_sampler).replace("    own.manual_seed(99)\n",
                                                         "    own = gen\n"), ns)
        check_sampler = ns["check_sampler"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    for fn in (check_sampler, cs.check_paged_cell, cs.check_attention, cs.check_paged_stream,
               cs.check_token_row, cs.check_fused_step, cs.check_fused_step_int8,
               cs.check_attention_bwd, cs.check_event_loop):
        fn(card, gen)
    return gen


def main(argv=()) -> int:
    global MODEL, FUSED
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=40, help="fresh generator streams to run")
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("probe_ragged_ties_torch.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.library()
    card = cs.card_line()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    MODEL = init_model(config, seed=4, dtype=torch.float32, device=dev)
    FUSED = fs.prepare_fused(MODEL.net)
    t0 = time.time()
    results = [ragged_f32(inputs(phase2_stream(card, first)), label)
               for first, label in ((True, "phase 2 with the sampler check's cases all "
                                     "drawn from the shared generator"),
                                    (False, "phase 2 as committed"))]
    for seed in range(1, args.seeds + 1):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        results.append(ragged_f32(inputs(gen), f"seed {seed}"))
    print(json.dumps({"probe_seconds": time.time() - t0,
                      "streams_with_differences": sum(bool(r["differing_slots"]) for r in results),
                      "streams": len(results), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
