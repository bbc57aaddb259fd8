"""The readers of the program's spans and counters, on synthetic traced
runs worked by hand: spans and counters recorded by the program's
recorder (``profiling.recording()``) and stamped here, device intervals
built here, spans of each kind straddling an edge of the window: they are
left out."""

from types import SimpleNamespace

import pytest
import torch.autograd.profiler

from bench_h100 import spec
from bench_h100.tracing import TraceSummary
from midi_model_tpu_torch.utils import profiling

MS = 1_000_000
WINDOW = (100 * MS, 200 * MS)


@pytest.fixture(autouse=True)
def recorder():
    with profiling.recording():
        yield
    profiling.reset()


def span(name, start_ms, end_ms, **attrs):
    """A span recorded by the program's recorder, stamped at the given
    times."""
    sp = profiling.span(name)
    sp.attrs.update(attrs)
    sp.finish()
    sp.start, sp.end = int(start_ms * MS), int(end_ms * MS)
    return sp


def count(**counters):
    for name, n in counters.items():
        profiling.count(name.replace("__", "."), n)


def trace(device=(), launches=None):
    """``device``: (start ms, end ms, launch ms or None)."""
    ops, at = [], {}
    for corr, (s, e, launch) in enumerate(device):
        ops.append((int(s * MS), int(e * MS), f"op{corr}", corr))
        if launch is not None:
            at[corr] = int(launch * MS)
    return TraceSummary(WINDOW, ops, [], at if launches is None else launches)


def serve_run(device=()):
    return SimpleNamespace(records=[], trace=trace(device))


def train_run(device=()):
    return SimpleNamespace(steps=[(0, 0, 0.0, 0)], trace=trace(device))


def read(metric, run):
    return spec.reader(metric)(run)


def test_lock_and_queue_waits_are_the_p95_of_the_window():
    span("service.lock_wait", 90, 190)  # starts before the window: left out
    for d in range(1, 22):
        span("service.lock_wait", 100 + d, 100 + 2 * d)
    span("service.lock_wait", 190, 260)  # cut by the window's end: left out
    span("batcher.queued", 150, 150.5)
    span("batcher.queued", 160, 170)
    span("batcher.queued", 199, 260)  # cut by the window's end
    run = serve_run()
    assert read("service.lock_wait_p95_ms.ttfc", run) == pytest.approx(20.0)
    assert read("batcher.queue_wait_p95_ms.ttfc", run) == pytest.approx(
        0.5 + 0.95 * (10 - 0.5))


def test_prefill_counter_ratios():
    span("batcher.admit", 120, 130)
    count(batcher__prefill_forwards=4, batcher__prefill_prompts=5,
          batcher__prefill_prompt_rows=3000, batcher__prefill_bucket_rows=5 * 1024)
    run = serve_run()
    assert read("batcher.rows_per_prefill.ttfc", run) == pytest.approx(1.25)
    assert read("batcher.prefill_useful_share.ttfc", run) == pytest.approx(100 * 3000 / 5120)


def test_admit_ms_per_chunk_counts_the_windows_spans():
    span("batcher.admit", 95, 105)  # starts before the window
    span("batcher.admit", 110, 116)
    span("batcher.admit", 150, 160)
    span("batcher.admit", 190, 204)  # cut by the window's end
    for start in (98, 120, 150, 180, 199.5):
        span("batcher.dispatch", start, start + 1)
    assert read("batcher.admit_ms_per_chunk.gap", serve_run()) == pytest.approx(16 / 3)


def test_slot_useful_share():
    span("batcher.step", 120, 130)
    count(batcher__rows_delivered=1500, batcher__slot_steps=2048)
    assert read("batcher.slot_useful_share.events", serve_run()) == pytest.approx(
        100 * 1500 / 2048)


def test_idle_in_step_clips_to_the_window():
    # device busy 100-110, 130-170, 185-200: idle 110-130 and 170-185
    device = [(100, 110, None), (130, 170, None), (185, 200, None)]
    span("batcher.step", 90, 115)  # straddles the window's start: 110-115 idle
    span("batcher.step", 120, 140)  # 120-130 idle
    span("batcher.step", 175, 260)  # 175-185 idle
    span("batcher.admit", 110, 130)
    assert read("device.idle_in_step_share.events", serve_run(device)) == pytest.approx(
        100 * 25 / 100)


def test_idle_outside_every_step_reads_zero():
    device = [(100, 110, None), (130, 170, None), (185, 200, None)]
    span("batcher.step", 130, 170)
    assert read("device.idle_in_step_share.events", serve_run(device)) == 0.0


def test_device_ops_per_step_joins_launches():
    span("train.step", 95, 105)  # starts before the window: left out
    span("train.step", 110, 150)
    span("train.step", 160, 195)
    span("train.step", 197, 230)  # cut by the window's end: left out
    device = [(104, 106, 100),  # launched inside the left-out step
              (120, 121, 111), (122, 123, 149), (151, 152, 150.5),  # 2 in, 1 between
              (170, 171, 161), (172, 173, None),  # one with no launch found
              (196, 196.5, 195.5),  # launched between steps
              (198, 199, 197.5)]  # launched in the step cut by the window's end
    assert read("train.device_ops_per_step.train", train_run(device)) == pytest.approx(3 / 2)


def test_optimizer_share_of_the_steps_host_time():
    for name, start, end in [("train.step", 95, 105), ("train.optimizer", 99, 104),
                             ("train.step", 110, 150), ("train.optimizer", 140, 150),
                             ("train.step", 155, 190), ("train.optimizer", 180, 190),
                             ("train.step", 190, 210), ("train.optimizer", 195, 210),
                             ("train.microbatch", 110, 130)]:
        span(name, start, end)
    assert read("train.optimizer_share.train", train_run()) == pytest.approx(100 * 20 / 75)


SERVE = ["service.lock_wait_p95_ms.ttfc", "batcher.queue_wait_p95_ms.ttfc",
         "batcher.rows_per_prefill.ttfc", "batcher.prefill_useful_share.ttfc",
         "batcher.admit_ms_per_chunk.gap", "batcher.slot_useful_share.events",
         "device.idle_in_step_share.events"]
TRAIN = ["train.device_ops_per_step.train", "train.optimizer_share.train"]


@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_no_spans_no_reading(metric, monkeypatch):
    """A recorder that recorded nothing, a program without the recorder, an
    untraced run and a run of the other kind leave the metric out."""
    own, other = (serve_run, train_run) if metric in SERVE else (train_run, serve_run)
    assert read(metric, own()) is None
    span("batcher.step" if metric in SERVE else "train.step", 110, 120)
    assert read(metric, other()) is None
    untraced = own()
    untraced.trace = None
    assert read(metric, untraced) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(metric, own()) is None


def test_a_torch_the_recorder_cannot_see_fails_the_run(monkeypatch):
    span("batcher.step", 110, 120)
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    with pytest.raises(RuntimeError, match="_is_profiler_enabled"):
        read("batcher.slot_useful_share.events", serve_run())


def test_empty_shares_read_zero():
    span("batcher.step", 110, 120)
    for metric in ("service.lock_wait_p95_ms.ttfc", "batcher.queue_wait_p95_ms.ttfc",
                   "batcher.rows_per_prefill.ttfc", "batcher.prefill_useful_share.ttfc",
                   "batcher.admit_ms_per_chunk.gap", "batcher.slot_useful_share.events"):
        assert read(metric, serve_run()) == 0.0, metric
