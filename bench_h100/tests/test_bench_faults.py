"""``correct`` comes out false with the timed path broken underneath, once
for each fault the cells can have, and true without one.  The harness's
look for a chip is skipped: the cells run at the tiny size on the CPU."""

import numpy as np
import pytest

from bench_h100.tests import tiny


def alter_a_token(batcher):
    """A token altered where it is produced: the second token of every row
    a chunk decodes moved to the next id of its range."""
    dispatch = batcher._dispatch
    pad, lo = batcher.tokenizer.pad_id, 3 + len(batcher.tokenizer.vocab.events)

    def altered(*a, **k):
        rows, ready, snap = dispatch(*a, **k)
        live = rows[:, :, 1] != pad
        rows[:, :, 1] = np.where(live, np.where(rows[:, :, 1] > lo, rows[:, :, 1] - 1,
                                                rows[:, :, 1] + 1), rows[:, :, 1])
        return rows, ready, snap

    batcher._dispatch = altered


def state_unchanged(batcher):
    """A decode step that returns its state unchanged: each chunk starts
    from the hidden state the slots had before the last one."""
    dispatch = batcher._dispatch

    def stale(*a, **k):
        hidden = batcher._hidden.clone()
        out = dispatch(*a, **k)
        batcher._hidden = hidden
        return out

    batcher._dispatch = stale


def step_state_unchanged(step):
    """A training step that returns its state unchanged."""
    def stale(state, batch):
        before = {n: p.detach().clone() for n, p in state.params.items()}
        state, metrics = step(state, batch)
        for n, p in state.params.items():
            p.data.copy_(before[n])
        return state, metrics
    return stale


def half_batch(step):
    """Half of each microbatch's rows left out, the mean taken over the rest."""
    def half(state, batch):
        return step(state, batch[:, : batch.shape[1] // 2])
    return half


SERVING = ["tv2o-medium.app_steady", "tv2o-medium.app_steady_int8"]


@pytest.mark.parametrize("workload", SERVING)
def test_sound_serving_run_is_correct(workload):
    result, check = tiny.run(workload)
    assert result["correct"], check


@pytest.mark.parametrize("workload", SERVING)
@pytest.mark.parametrize("fault", [alter_a_token, state_unchanged], ids=lambda f: f.__name__)
def test_serving_fault_is_caught(fault, workload):
    result, check = tiny.run(workload, fault=fault)
    assert not result["correct"], check


def test_sound_training_run_is_correct():
    result, check = tiny.run("tv2o-medium.train")
    assert result["correct"], check


@pytest.mark.parametrize("fault", [step_state_unchanged, half_batch], ids=lambda f: f.__name__)
def test_training_fault_is_caught(fault):
    result, check = tiny.run("tv2o-medium.train", fault=fault)
    assert not result["correct"], check


def test_control_reads_wider_than_the_program():
    """At the tiny size the fp8 control's widest gap exceeds the program's
    (f32 here: 0) at the same positions."""
    import time

    import torch

    from bench_h100 import serve_cell, weights
    from bench_h100.reference.judge import serve_readings

    cell = tiny.tiny_cell("tv2o-medium.app_steady")
    torch.set_num_threads(2)
    run, _, numbers = serve_cell.run(cell, 11, 2.0, False, torch.device("cpu"), time.perf_counter())
    reqs = serve_cell.sample_requests(run, 11)
    state = weights.make(cell.config, 11, torch.float32, "cpu")
    control = serve_readings(cell.config, state, reqs, "cpu", control=True)
    assert numbers["logit_gap"] <= cell.limits["limits"]["logit_gap"] < control["logit_gap"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["tv2o-medium.app_steady", "tv2o-large.app_saturated",
                                      "tv2o-medium.app_prompt", "tv2o-medium.train",
                                      "tv2o-medium.app_steady_int8"])
def test_control_fails_the_cell_on_the_card(cuda_device, workload):
    """The control at the cell's own size on three seeds: it fails one of
    the cell's numbers where the program passes them."""
    from bench_h100 import control, spec

    cell = spec.find_cell(workload)
    limits = cell.limits["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        cell = spec.find_cell(workload)
        if cell.traffic["kind"] == "serve":
            out = control.serve_seed(cell, seed, 10.0, cuda_device)
        else:
            out = control.train_seed(cell, seed, cuda_device)
        prog, ctrl = out["program"], out["control_fp8"]
        assert all(prog[k] <= limits[k] for k in prog if k in limits)
        assert any(ctrl[k] > limits[k] for k in ctrl if k in limits)
