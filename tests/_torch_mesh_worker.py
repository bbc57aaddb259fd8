"""Rank programs for the port's multi-process tests (``test_torch_sharded.py``,
``test_torch_batcher_mesh.py``).

This module imports torch and the port only: the ranks are spawned
processes that import it by name, and they must never load jax.  Each
suite runs every case of its test module in one process group
(``parallel.spawn``, gloo on the CPU); a case's mesh takes the first
``dp * tp`` ranks, and each rank pickles what its cases returned to
``<out_dir>/rank<r>.pkl`` for the parent test to compare.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.midinet import MIDINet
from midi_model_tpu_torch.parallel import all_reduce_sum, gather_shards, make_mesh, process_shard
from midi_model_tpu_torch.sampling import build_mask_table, mask_tensors, normalize_prompt
from midi_model_tpu_torch.sampling.sharded import (decode_events_dp, generate_dp,
                                                   generate_tp, prefill_dp, shard_seed,
                                                   tp_shard_params)
from midi_model_tpu_torch.serve import ContinuousBatcher

# the JAX package's test sizes: data parallel and the batchers at a 4-layer,
# 4-head x 16, 64-wide net; tensor-parallel generation at 8 heads x 32 (4
# local heads fill one 128-lane pool row)
TINY = dict(n_layer=4, n_head=4, n_embd=64, n_inner=128)
TP_DIMS = dict(n_layer=4, n_head=8, n_embd=256, n_inner=256)


def config_of(dims: dict) -> MIDIModelConfig:
    return MIDIModelConfig.get_config("v2", True, **dims)


def state_dict_of(dims: dict, seed: int = 0) -> dict:
    """Reference-layout f32 weights synthesized from ``seed`` (the same
    numbers in every process)."""
    model = MIDINet(config_of(dims), device="meta")
    return synthesize_state_dict([(k, tuple(v.shape)) for k, v in model.state_dict().items()],
                                 seed)


def model_of(dims: dict, seed: int = 0) -> MIDINet:
    return params_from_state_dict(state_dict_of(dims, seed), config_of(dims), device="cpu")


def bos_prompt(tok, extra: int = 0) -> np.ndarray:
    rows = [[tok.bos_id] + [tok.pad_id] * (tok.max_token_seq - 1)]
    for i in range(extra):
        rows.append(tok.event2tokens(["set_tempo", 0, 0, 0, 100 + i]))
    return np.asarray(rows, np.int32)


# ---- generation (test_torch_sharded.py) ------------------------------------

GEN_TP = dict(batch_size=2, max_len=10)
DP_CHUNK = dict(batch=4, n_events=4, max_seq=64, seed=7)
GEN_DP = dict(batch_size=4, max_len=10, chunk_size=4, seed=11)
GEN_DP_GREEDY = dict(batch_size=8, max_len=12, chunk_size=4, greedy=True)


def _tp_generate(mesh, **kw):
    model = tp_shard_params(model_of(TP_DIMS), mesh)
    return generate_tp(model, config_of(TP_DIMS), mesh, **GEN_TP, **kw)


def _dp_chunk(mesh):
    cfg = config_of(TINY)
    model = model_of(TINY)
    prompt = normalize_prompt(cfg.tokenizer, None, DP_CHUNK["batch"])
    state = prefill_dp(model, cfg, prompt, DP_CHUNK["max_seq"], mesh)
    generator = torch.Generator().manual_seed(shard_seed(DP_CHUNK["seed"], mesh.data_rank))
    masks = mask_tensors(build_mask_table(cfg.tokenizer), "cpu")
    _, rows, n_done, all_eos = decode_events_dp(
        model, cfg, state, masks, DP_CHUNK["n_events"], 1.0, 0.98, 20, generator, mesh)
    return rows, n_done, all_eos


SHARD_FILES = [f"f{i}" for i in range(11)]


def _collectives(mesh):
    """A bf16 all-reduce over the model group (in place, in its dtype) and
    a gather over the host group."""
    x = torch.full((3,), 1.0 + mesh.model_rank, dtype=torch.bfloat16)
    same = all_reduce_sum(x, mesh.model_group) is x
    rows = gather_shards(mesh, np.full((1, 2), mesh.model_rank, np.int32))
    return same, x.tolist(), str(x.dtype), rows


GENERATION = [
    ("process_shard", 2, 1, lambda mesh: process_shard(SHARD_FILES)),
    ("collectives", 1, 2, _collectives),
    ("tp_greedy", 1, 2, lambda mesh: _tp_generate(mesh, greedy=True)),
    ("tp_greedy_int8", 1, 2, lambda mesh: _tp_generate(mesh, greedy=True, kv_int8=True)),
    ("tp_sampled", 1, 2, lambda mesh: _tp_generate(mesh, seed=5)),
    ("dp_chunk", 2, 1, _dp_chunk),
    ("dp_generate", 2, 1, lambda mesh: generate_dp(model_of(TINY), config_of(TINY), mesh,
                                                   **GEN_DP)),
    ("dp_greedy", 2, 1, lambda mesh: generate_dp(model_of(TINY), config_of(TINY), mesh,
                                                 **GEN_DP_GREEDY)),
]


# ---- continuous batching (test_torch_batcher_mesh.py) ----------------------

def batcher_plans(tok) -> dict:
    """name -> (dp, tp, batcher keywords, plan).  A plan is ``[(submit
    before step i, prompt, budget), ...]``; the keywords take ``greedy``
    or ``seed`` from the case."""
    three = [(0, bos_prompt(tok), 5), (0, bos_prompt(tok, 2), 7), (0, bos_prompt(tok, 1), 4)]
    return {
        "dp4": (4, 1, dict(n_slots=4, max_seq=64, chunk=3),
                [(0, bos_prompt(tok, e), n) for e, n in ((0, 5), (2, 7), (1, 4), (3, 6), (0, 3))]),
        "dp8_staggered": (8, 1, dict(n_slots=8, max_seq=64, chunk=4),
                          [(0, bos_prompt(tok), 6), (1, bos_prompt(tok, 2), 5)]),
        "tp2": (1, 2, dict(n_slots=2, max_seq=64, chunk=3), three),
        "dp2_tp2": (2, 2, dict(n_slots=4, max_seq=64, chunk=3),
                    [(0, bos_prompt(tok, i), n) for i, n in enumerate((5, 6, 4, 7, 3))]),
        "tp2_int8": (1, 2, dict(n_slots=2, max_seq=64, chunk=3, kv_int8=True), three),
    }


# each plan greedy and sampled (the batcher's seed gives every request its own)
MODES = {"greedy": dict(greedy=True), "sampled": dict(seed=7)}


def drive(batcher, plan, max_steps: int = 500) -> list:
    """Submit each request of ``plan`` before its step and step until every
    request finished; [(rows, reason), ...] in plan order.  Takes the port's
    batcher and the JAX package's alike."""
    pending = sorted(plan, key=lambda p: p[0])
    ids, results = [], {}
    for step in range(max_steps):
        while pending and pending[0][0] <= step:
            _, prompt, budget = pending.pop(0)
            ids.append(batcher.submit(prompt, budget))
        if not pending and not batcher.any_active:
            break
        results.update((f.request_id, f) for f in batcher.step())
    else:
        raise RuntimeError(f"the session did not drain in {max_steps} steps")
    return [(np.asarray(results[r].rows), results[r].reason) for r in ids]


def _batcher_case(name: str, mode: str):
    def run(mesh):
        cfg = config_of(TINY)
        _, _, kw, plan = batcher_plans(cfg.tokenizer)[name]
        return drive(ContinuousBatcher(model_of(TINY), cfg, mesh=mesh, **kw, **MODES[mode]),
                     plan)
    return run


def _batcher_cases():
    plans = batcher_plans(config_of(TINY).tokenizer)
    return [(f"{name}_{mode}", dp, tp, _batcher_case(name, mode))
            for name, (dp, tp, _, _) in plans.items() for mode in MODES]


SUITES = {"generation": (2, lambda: GENERATION), "batcher": (8, _batcher_cases)}


def fail_on_rank(rank: int) -> None:
    """A rank program that raises on ``rank`` (``parallel.spawn``'s failure path)."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")


def sleep_forever() -> None:
    """A rank program that never ends (``parallel.spawn``'s time limit)."""
    import time

    while True:
        time.sleep(1)


def same_on_every_rank(ranks: list, case: str):
    """``case``'s result from the ranks' pickles, which every rank of its
    mesh must have returned alike."""
    got = [r[case] for r in ranks if case in r]
    assert got and all(pickle.dumps(g) == pickle.dumps(got[0]) for g in got[1:]), case
    return got[0]


def run_suite(suite: str, out_dir: str) -> None:
    """One rank's share of ``suite``: every case in order, on the ranks of
    its mesh (the others pass it); the results pickled per rank."""
    torch.set_num_threads(1)
    results = {}
    for name, dp, tp, case in SUITES[suite][1]():
        mesh = make_mesh(dp, tp, device="cpu")
        if mesh is not None:
            results[name] = case(mesh)
    path = Path(out_dir) / f"rank{dist.get_rank()}.pkl"
    path.write_bytes(pickle.dumps(results))
