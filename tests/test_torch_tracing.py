"""The port's span-and-counter recorder (``utils.profiling``) on the CPU:
off by default and then recording nothing, nesting and parents per thread,
the bounded buffer, the profiler's clock, and the spans and counters of
the batcher, the service and the training step at the tiny size, whose
rows and losses do not change with the recorder on."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.midinet import init_model
from midi_model_tpu_torch.ops import fused_step as fs
from midi_model_tpu_torch.serve import BatcherService, ContinuousBatcher
from midi_model_tpu_torch.serve.batcher import PREFILL_BUCKETS
from midi_model_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from midi_model_tpu_torch.utils import profiling

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tiny():
    _, cfg, _, model, _ = tiny_models(seed=0)
    return cfg, model


@pytest.fixture(autouse=True)
def empty_record():
    profiling.reset()
    yield
    profiling.reset()


def named(spans, name):
    return [s for s in spans if s.name == name]


def bos_prompt(tok, extra=0):
    rows = [[tok.bos_id] + [tok.pad_id] * (tok.max_token_seq - 1)]
    for i in range(extra):
        rows.append(tok.event2tokens(["set_tempo", 0, 0, 0, 100 + i % 50]))
    return np.asarray(rows, np.int32)


# (prompt rows, budget): A and B fill the 2 slots and end in the same
# chunk; C and D then share one prefill forward, E follows alone; B's
# prompt lies in another bucket
PLAN = [(1, 4), (70, 4), (2, 3), (3, 3), (1, 2)]


def run_plan(cfg, model, pipeline):
    b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3, greedy=True,
                          disable_eos=True, pipeline=pipeline)
    tok = cfg.tokenizer
    rids = [b.submit(bos_prompt(tok, n - 1), max_events=budget) for n, budget in PLAN]
    results = b.run_all()
    return [results[r].rows for r in rids], rids, b.page_size


def bucket_of(n, page):
    bucket = next((b for b in PREFILL_BUCKETS if b >= n), n)
    return -(-bucket // page) * page


def test_off_records_nothing_and_returns_the_null_span(tiny):
    cfg, model = tiny
    assert not profiling.on()
    sp = profiling.span("test.off")
    assert sp is profiling.NULL and not sp
    with sp as inner:
        assert inner is profiling.NULL
    profiling.count("test.off")
    assert profiling.current() is None
    run_plan(cfg, model, pipeline=False)
    assert profiling.snapshot() == ([], {})


def test_nesting_and_parents_one_stack_per_thread():
    ready = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"{tag}.outer") as outer:
            ready.wait()  # both threads hold their outer span at once
            with profiling.span(f"{tag}.inner") as inner:
                assert profiling.current() == inner.id
                profiling.span(f"{tag}.given", parent=outer.id).finish()
            assert profiling.current() == outer.id
            ready.wait()

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    spans, _ = profiling.snapshot()
    by = {s.name: s for s in spans}
    assert len(spans) == 6
    for tag in ("a", "b"):
        outer, inner, given = by[f"{tag}.outer"], by[f"{tag}.inner"], by[f"{tag}.given"]
        assert outer.parent is None
        assert inner.parent == outer.id and given.parent == outer.id
        assert outer.start <= inner.start <= inner.end <= outer.end
        assert outer.thread == inner.thread == given.thread
    assert by["a.outer"].thread != by["b.outer"].thread
    assert len({s.id for s in spans}) == 6


def test_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("test.many"):
                pass
        profiling.count("test.counted", 2)
        profiling.count("test.counted")
    spans, counters = profiling.snapshot()
    assert len(spans) == 3
    assert counters == {"test.counted": 3, profiling.DROPPED: 2}
    with profiling.recording():  # a new recording starts empty
        pass
    assert profiling.snapshot() == ([], {})


def test_spans_on_the_profilers_clock():
    """Inside ``recording()`` each span is a ``record_function`` of its name,
    and its start lies within 1 ms of that event's on the profiler's clock."""
    with profiling.recording():
        with profiling.span("test.warm"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                with profiling.span("test.clock"):
                    torch.ones(4).add_(1)
    spans = named(profiling.snapshot()[0], "test.clock")
    events = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "test.clock")
    assert len(spans) == len(events) == 5
    for s, t in zip(sorted(spans, key=lambda s: s.start), events):
        assert abs(s.start - t) < 1_000_000, (s.start, t)


def test_a_profiler_capture_records_without_ranges():
    """A ``torch.profiler`` capture alone turns the recorder on; its spans
    are kept in memory and put no range on the profiler's timeline."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        with profiling.span("test.captured"):
            torch.ones(4).add_(1)
        profiling.count("test.captured")
    assert not profiling.on()
    spans, counters = profiling.snapshot()
    assert [s.name for s in spans] == ["test.captured"] and counters == {"test.captured": 1}
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name() == "test.captured"]


def test_each_capture_starts_from_an_empty_record():
    for tag in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.span(f"test.{tag}").finish()
            profiling.count(f"test.{tag}")
        assert not profiling.on()  # a call site between the captures
    spans, counters = profiling.snapshot()
    assert [s.name for s in spans] == ["test.second"] and counters == {"test.second": 1}


def test_trace_writes_the_program_spans(tmp_path):
    with profiling.trace(str(tmp_path / "traces")):
        with profiling.span("test.in_trace"):
            torch.ones(4).add_(1)
    files = list((tmp_path / "traces").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "test.in_trace" for e in events)
    assert not profiling.on()


@pytest.mark.parametrize("pipeline", [False, True], ids=["plain", "pipelined"])
def test_batcher_spans_and_counters(tiny, pipeline):
    cfg, model = tiny
    with profiling.recording():
        rows, rids, page = run_plan(cfg, model, pipeline)
    spans, counters = profiling.snapshot()
    lens = dict(zip(rids, [n for n, _ in PLAN]))

    admits = named(spans, "batcher.admit")
    assert sorted(r for a in admits for r in a.attrs["rids"]) == sorted(rids)
    for a in admits:
        group = a.attrs["rids"]
        assert a.attrs["group"] == len(group)
        assert {bucket_of(lens[r], page) for r in group} == {a.attrs["bucket"]}
        assert a.attrs["prompt_rows"] == sum(lens[r] for r in group)
        assert a.attrs["pad_rows"] == len(group) * a.attrs["bucket"] - a.attrs["prompt_rows"]
    assert sorted(a.attrs["group"] for a in admits) == [1, 1, 1, 2]
    assert counters["batcher.prefill_forwards"] == len(admits) == 4
    assert counters["batcher.prefill_prompts"] == len(PLAN)
    assert counters["batcher.prefill_prompt_rows"] == sum(lens.values())
    assert counters["batcher.prefill_bucket_rows"] == sum(
        a.attrs["group"] * a.attrs["bucket"] for a in admits)

    queued = named(spans, "batcher.queued")
    assert sorted(q.attrs["rid"] for q in queued) == sorted(rids)
    admit_of = {r: a for a in admits for r in a.attrs["rids"]}
    for q in queued:
        assert q.attrs["prompt_rows"] == lens[q.attrs["rid"]]
        assert q.end <= admit_of[q.attrs["rid"]].start

    steps = named(spans, "batcher.step")
    dispatches = named(spans, "batcher.dispatch")
    assert len(named(spans, "batcher.wait_rows")) == len(dispatches)
    assert {d.parent for d in dispatches} <= {s.id for s in steps}
    assert all(1 <= d.attrs["live_slots"] <= 2 for d in dispatches)
    assert counters["batcher.slot_steps"] == 2 * 3 * len(dispatches)
    assert counters["batcher.rows_delivered"] == sum(len(r) for r in rows) == 16
    assert set(counters) == {"batcher.prefill_forwards", "batcher.prefill_prompts",
                             "batcher.prefill_prompt_rows", "batcher.prefill_bucket_rows",
                             "batcher.slot_steps", "batcher.rows_delivered"}


@pytest.fixture(scope="module")
def packed():
    """A one-layer event net of 8 heads x 64 (packed pages): the ragged event
    loop's path (its plain version on the CPU)."""
    cfg = MIDIModelConfig.get_config("v2", True, n_layer=1, n_head=8, n_embd=512, n_inner=64)
    return cfg, init_model(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("pipeline", [False, True], ids=["plain", "pipelined"])
def test_event_loop_attention_counters(packed, pipeline, monkeypatch):
    """On the ragged event loop's path the batcher counts the whole step's
    attention work items a layer and the slots split over several, summed
    over each chunk's events by ``fs.chunk_attention_counts``: equal to the
    rule over the device's index and the active slots at each dispatch
    (exact on the CPU; eos disabled, so no slot retires mid-chunk); rows
    bit-identical with the recorder on."""
    cfg, model = packed
    seen = []
    dispatch = ContinuousBatcher._dispatch

    def watched(self):
        seen.append((self._index.numpy().copy(), self._active[self._mine].copy()))
        return dispatch(self)

    def run():
        b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3, greedy=True,
                              disable_eos=True, pipeline=pipeline, fused=True)
        assert b.path == "event_loop"
        rids = [b.submit(bos_prompt(cfg.tokenizer, n - 1), max_events=budget)
                for n, budget in PLAN]
        results = b.run_all()
        return [results[r].rows for r in rids], b

    off, _ = run()
    monkeypatch.setattr(ContinuousBatcher, "_dispatch", watched)
    with profiling.recording():
        on, b = run()
    _, counters = profiling.snapshot()
    for x, y in zip(off, on):
        np.testing.assert_array_equal(x, y)
    want = [fs.chunk_attention_counts(index, active, b.chunk, b.max_seq)
            for index, active in seen]
    assert counters["batcher.attention_items"] == sum(w[0] for w in want) > 0
    assert counters["batcher.attention_split_slots"] == sum(w[1] for w in want) > 0
    assert counters["batcher.slot_steps"] == 2 * 3 * len(seen)



@pytest.mark.parametrize("cluster", [1, 2], ids=["unclustered", "clustered"])
def test_clustered_launches_counter(packed, cluster, monkeypatch):
    """``batcher.clustered_launches``: the decode-kernel launches of each
    chunk that ran in thread-block clusters (``_build.count_launch``), one a
    chunk on the ragged event loop; absent where none did (the CPU's plain
    versions launch nothing)."""
    from midi_model_tpu_torch.ops import _build
    from midi_model_tpu_torch.ops import event_loop as el

    cfg, model = packed
    ragged = el.decode_event_block_ragged

    def launched(*args, **kw):  # as the CUDA wrapper counts its launch
        _build.count_launch("event_loop_ragged", (cluster, 132))
        return ragged(*args, **kw)

    monkeypatch.setattr(el, "decode_event_block_ragged", launched)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    monkeypatch.setattr(_build, "SHAPES", {})
    b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3, greedy=True,
                          disable_eos=True, fused=True)
    assert b.path == "event_loop"
    with profiling.recording():
        for n, budget in PLAN:
            b.submit(bos_prompt(cfg.tokenizer, n - 1), max_events=budget)
        b.run_all()
    spans, counters = profiling.snapshot()
    chunks = len(named(spans, "batcher.dispatch"))
    assert chunks == _build.LAUNCHES["event_loop_ragged"] > 0
    if cluster > 1:
        assert counters["batcher.clustered_launches"] == chunks
        assert _build.LAUNCHES["event_loop_ragged.clustered"] == chunks
    else:
        assert "batcher.clustered_launches" not in counters
        assert "event_loop_ragged.clustered" not in _build.LAUNCHES


def test_submit_group_spans(tiny):
    cfg, model = tiny
    tok = cfg.tokenizer
    svc = BatcherService(ContinuousBatcher(model, cfg, n_slots=4, max_seq=64, chunk=3,
                                           greedy=True, disable_eos=True))
    try:
        with profiling.recording():
            chunks = list(svc.submit_group([bos_prompt(tok), bos_prompt(tok, 2)], max_events=4))
    finally:
        svc.close()
    assert sum(c.shape[1] for c in chunks) == 4
    spans, counters = profiling.snapshot()
    (wait,) = named(spans, "service.lock_wait")
    (submit,) = named(spans, "service.submit")
    assert wait.attrs["group"] == 2 and wait.end <= submit.start
    rids = submit.attrs["rids"]
    assert len(rids) == 2
    assert sorted(q.attrs["rid"] for q in named(spans, "batcher.queued")) == sorted(rids)
    assert {q.parent for q in named(spans, "batcher.queued")} == {submit.id}
    # the slots were free: each row's prefill ran inside the submission
    assert {a.parent for a in named(spans, "batcher.admit")} == {submit.id}
    assert counters["batcher.rows_delivered"] == 8


def tiny_batch(cfg):
    rng = np.random.default_rng(0)
    b = rng.integers(3, cfg.tokenizer.vocab_size, (2, 4, 16, 8)).astype(np.int32)
    b[:, :, -2:, :] = cfg.tokenizer.pad_id
    return b


def train_once(cfg, model, batch):
    opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt, accum_steps=2, compute_dtype=torch.float32)
    state = init_train_state({n: p.detach().clone() for n, p in model.named_parameters()}, opt)
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    return losses, state.params


def test_train_step_spans(tiny):
    cfg, model = tiny
    with profiling.recording():
        train_once(cfg, model, tiny_batch(cfg))
    spans, _ = profiling.snapshot()
    steps = named(spans, "train.step")
    assert len(steps) == 2
    for step in steps:
        micro = [s for s in named(spans, "train.microbatch") if s.parent == step.id]
        assert [m.attrs["index"] for m in micro] == [0, 1]
        (opt,) = [s for s in named(spans, "train.optimizer") if s.parent == step.id]
        assert micro[1].end <= opt.start <= opt.end <= step.end


@pytest.mark.parametrize("path", ["batcher", "train"])
def test_outputs_bit_identical_with_the_recorder_on(tiny, path):
    cfg, model = tiny
    if path == "batcher":
        off = run_plan(cfg, model, pipeline=True)[0]
        with profiling.recording():
            on = run_plan(cfg, model, pipeline=True)[0]
        for a, b in zip(off, on):
            np.testing.assert_array_equal(a, b)
        return
    batch = tiny_batch(cfg)
    off_losses, off_params = train_once(cfg, model, batch)
    with profiling.recording():
        on_losses, on_params = train_once(cfg, model, batch)
    assert [float(x) for x in off_losses] == [float(x) for x in on_losses]
    for n in off_params:
        assert torch.equal(off_params[n], on_params[n]), n
