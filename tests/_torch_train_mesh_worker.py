"""Rank programs for the port's multi-process training tests
(``test_torch_train_mesh.py``).

This module imports torch and the port only: the ranks are spawned
processes that import it by name, and they must never load jax.  One
suite runs every case in one process group of four gloo ranks on the CPU
(``parallel.spawn``); a case's mesh takes the first ``dp * tp`` ranks, and
each rank pickles what its cases returned, in the single-device layout
(``train.sharding.gather_params``), to ``<out_dir>/rank<r>.pkl``.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.lora import peft_state_dict_to_lora
from midi_model_tpu_torch.models.midinet import MIDINet
from midi_model_tpu_torch.parallel import (copy_to_model, gather_vocab, make_mesh,
                                           reduce_from_model)
from midi_model_tpu_torch.train import trainer as tr
from midi_model_tpu_torch.train.sharding import gather_params, shard_params, split_axis

# an event net of 8 heads x 8 and a token net of one layer of 2 heads x 32:
# tp=2 leaves one token-net head a shard
DIMS = dict(n_layer=4, n_head=8, n_embd=64, n_inner=128)
OPT = dict(lr=1e-4, warmup_steps=0, total_steps=1000)
CLIP = 0.05  # below every step's gradient norm here: the clip is active
LORA_RANK, LORA_ALPHA = 4, 8.0
STEPS, ACCUM = 2, 2


def config_of() -> MIDIModelConfig:
    return MIDIModelConfig.get_config("v2", True, **DIMS)


def state_dict_of(seed: int = 0) -> dict:
    """Reference-layout f32 weights synthesized from ``seed``."""
    model = MIDINet(config_of(), device="meta")
    return synthesize_state_dict([(k, tuple(v.shape)) for k, v in model.state_dict().items()],
                                 seed)


def params_of(seed: int = 0) -> dict:
    model = params_from_state_dict(state_dict_of(seed), config_of(), device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


def batches() -> dict:
    """name -> ``[ACCUM, B=4, L=16, T=8]``.  "plain": the last two events of
    every row are pad.  "pads": data shard 0's rows (0-1 at dp=2) are
    mostly pad, shard 1's hold none, so the shards' masked means differ
    from the global one."""
    tok = config_of().tokenizer
    rng = np.random.default_rng(0)
    plain = rng.integers(3, tok.vocab_size, (ACCUM, 4, 16, 8)).astype(np.int32)
    plain[:, :, -2:, :] = tok.pad_id
    pads = rng.integers(3, tok.vocab_size, (ACCUM, 4, 16, 8)).astype(np.int32)
    pads[:, 0, 3:, :] = tok.pad_id
    pads[:, 1, 9:, 2:] = tok.pad_id
    return {"plain": plain, "pads": pads}


def rows_of(batch: np.ndarray, mesh) -> np.ndarray:
    """This data shard's rows of every microbatch."""
    local = batch.shape[1] // mesh.dp
    return batch[:, mesh.data_rank * local:(mesh.data_rank + 1) * local]


def _np(params: dict) -> dict:
    return {n: p.detach().numpy().copy() for n, p in params.items()}


def full_steps(batch: str, remat=False, **opt):
    """``STEPS`` f32 steps of the full train step on the mesh: the
    gathered weights and each step's metrics."""
    def run(mesh):
        cfg = config_of()
        optimizer = tr.make_optimizer(**{**OPT, **opt})
        state = tr.init_train_state(shard_params(params_of(), mesh), optimizer)
        step = tr.make_train_step(cfg, optimizer, accum_steps=ACCUM,
                                  compute_dtype=torch.float32, remat=remat, mesh=mesh)
        data = rows_of(batches()[batch], mesh)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, data)
            metrics.append({k: float(v) for k, v in m.items()})
        return {"params": _np(gather_params(state.params, mesh)), "metrics": metrics}
    return run


def lora_steps(lora_np: dict):
    """``STEPS`` f32 LoRA steps over the mesh's base shards, from the
    adapters ``lora_np`` (peft's layout, numpy): the adapters, the metrics,
    and whether the base shards came out untouched."""
    def run(mesh):
        cfg = config_of()
        optimizer = tr.make_optimizer(**OPT)
        base = shard_params(params_of(), mesh)
        before = {n: p.clone() for n, p in base.items()}
        lora = peft_state_dict_to_lora(lora_np, cfg)
        state = tr.init_train_state(lora, optimizer)
        step = tr.make_lora_train_step(cfg, optimizer, lora_alpha=LORA_ALPHA, accum_steps=ACCUM,
                                       compute_dtype=torch.float32, mesh=mesh)
        data = rows_of(batches()["plain"], mesh)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, base, data)
            metrics.append({k: float(v) for k, v in m.items()})
        untouched = all(torch.equal(before[n], p) and not p.requires_grad
                        for n, p in base.items())
        return {"lora": _np(state.params), "metrics": metrics, "base_untouched": untouched}
    return run


def grads_and_norm(mesh):
    """One f32 microbatch's gradients (each data shard's rows, summed over
    the data group as the step sums them), gathered, and their global norm
    (``trainer.global_norm``: the split leaves' squares summed over the
    model group)."""
    cfg = config_of()
    params = {n: p.clone().requires_grad_(True)
              for n, p in shard_params(params_of(), mesh).items()}
    loss, _ = tr.loss_fn(params, cfg, rows_of(batches()["pads"], mesh)[0], torch.float32,
                         mesh=mesh)
    loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    tr.sum_over(grads, mesh.data_group)
    split = [n for n in grads if split_axis(n) is not None]
    return {"norm": float(tr.global_norm(grads, mesh, split)),
            "grads": _np(gather_params(grads, mesh))}


@torch.no_grad()
def eval_metrics(mesh):
    """``loss_fn`` in f32 over each data shard's rows of one microbatch, as
    ``eval_step`` runs it (bf16 there): the global masked means."""
    cfg = config_of()
    _, m = tr.loss_fn(shard_params(params_of(), mesh), cfg,
                      rows_of(batches()["pads"], mesh)[0], torch.float32, token_chunk=256,
                      mesh=mesh)
    return {k: float(v) for k, v in m.items()}


def operators(mesh):
    """The three autograd operators on a model group of two, each under a
    loss whose gradient is known in closed form (``test_operators_backward``),
    and ``reduce_from_model`` under ``no_grad`` (the serving path: in
    place)."""
    r = mesh.model_rank
    group = mesh.model_group
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_(True)
    (copy_to_model(x, group) * (r + 1.0)).sum().backward()
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_(True)
    c = torch.linspace(-1.0, 1.0, 6).reshape(2, 3)
    y = reduce_from_model(a * (r + 1.0), group)
    (y * c).sum().backward()
    v = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * r).requires_grad_(True)
    w = torch.linspace(0.5, 2.0, 12).reshape(2, 6)
    g = gather_vocab(v, group)
    (g * w).sum().backward()
    with torch.no_grad():
        z = torch.full((3,), 1.0 + r)
        same = reduce_from_model(z, group) is z
    return {"copy_grad": x.grad.numpy(), "reduce_value": y.detach().numpy(),
            "reduce_grad": a.grad.numpy(), "gather_value": g.detach().numpy(),
            "gather_grad": v.grad.numpy(), "no_grad_in_place": same,
            "no_grad_value": z.numpy(), "rank": r}


def cases(lora_np: dict) -> list:
    """(name, dp, tp, rank program)."""
    return [
        ("ops", 1, 2, operators),
        ("dp2", 2, 1, full_steps("plain")),
        ("tp2", 1, 2, full_steps("plain")),
        ("dp2_tp2", 2, 2, full_steps("plain")),
        ("pads_dp2", 2, 1, full_steps("pads")),
        ("pads_dp2_tp2", 2, 2, full_steps("pads")),
        ("clip_tp2", 1, 2, full_steps("plain", grad_clip=CLIP)),
        ("clip_dp2_tp2", 2, 2, full_steps("pads", grad_clip=CLIP)),
        ("remat_full_tp2", 1, 2, full_steps("plain", remat="full")),
        ("remat_dots_tp2", 1, 2, full_steps("plain", remat="dots")),
        ("remat_dots_all_dp2_tp2", 2, 2, full_steps("plain", remat="dots_all")),
        ("lora_dp2", 2, 1, lora_steps(lora_np)),
        ("lora_tp2", 1, 2, lora_steps(lora_np)),
        ("lora_dp2_tp2", 2, 2, lora_steps(lora_np)),
        ("eval_dp2_tp2", 2, 2, eval_metrics),
        ("grads_tp2", 1, 2, grads_and_norm),
        ("grads_dp2_tp2", 2, 2, grads_and_norm),
    ]


def run_suite(out_dir: str, lora_np: dict) -> None:
    """One rank's share of the suite: every case in order, on the ranks of
    its mesh (the others pass it); the results pickled per rank."""
    torch.set_num_threads(1)
    results, meshes = {}, {}
    for name, dp, tp, case in cases(lora_np):
        if (dp, tp) not in meshes:  # every rank makes the same groups, in order
            meshes[dp, tp] = make_mesh(dp, tp, device="cpu")
        mesh = meshes[dp, tp]
        if mesh is not None:
            results[name] = case(mesh)
    (Path(out_dir) / f"rank{dist.get_rank()}.pkl").write_bytes(pickle.dumps(results))
