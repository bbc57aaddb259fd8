"""The port's BatcherService: concurrent streaming clients over one shared
batch, mirroring ``tests/test_batcher_service.py`` — each stream equals its
request's solo-batcher greedy rows, which equal the JAX batcher's on the
same f32 weights."""

import numpy as np
import pytest

from midi_model_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
from midi_model_tpu_torch.serve import BatcherService, ContinuousBatcher

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, params, model, _ = tiny_models(seed=0)
    return jcfg, cfg, params, model


def bos_prompt(tok, extra=0):
    rows = [[tok.bos_id] + [tok.pad_id] * (tok.max_token_seq - 1)]
    for i in range(extra):
        rows.append(tok.event2tokens(["set_tempo", 0, 0, 0, 100 + i]))
    return np.asarray(rows, np.int32)


def solo_reference(model, cfg, prompts, budgets):
    """Ground truth: each request decoded greedily in its own batcher."""
    out = []
    for p, budget in zip(prompts, budgets):
        b = ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3, greedy=True)
        rid = b.submit(p, max_events=budget)
        out.append(b.run_all()[rid].rows)
    return out


def test_three_interleaved_streams(setup):
    """3 requests (one queued past the 2 slots) stream independently and
    reproduce their solo greedy rows, and the JAX batcher's."""
    jcfg, cfg, params, model = setup
    tok = cfg.tokenizer
    prompts = [bos_prompt(tok), bos_prompt(tok, 1), bos_prompt(tok, 2)]
    budgets = [5, 7, 4]
    refs = solo_reference(model, cfg, prompts, budgets)
    jb = JaxBatcher(params, jcfg, n_slots=2, max_seq=64, chunk=3, greedy=True)
    jids = [jb.submit(p, max_events=n) for p, n in zip(prompts, budgets)]
    jres = jb.run_all()
    for jid, ref in zip(jids, refs):
        np.testing.assert_array_equal(jres[jid].rows, ref)

    svc = BatcherService(ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3,
                                           greedy=True))
    try:
        handles = [svc.submit_stream(p, max_events=n) for p, n in zip(prompts, budgets)]
        for (rid, it), ref in zip(handles, refs):
            rows = np.asarray([r for chunk in it for r in np.asarray(chunk)],
                              np.int32).reshape(-1, tok.max_token_seq)
            np.testing.assert_array_equal(rows, ref)
            np.testing.assert_array_equal(svc.results[rid].rows, ref)
            assert svc.results[rid].reason in ("eos", "budget")
    finally:
        svc.close()


def test_group_streams_aligned_blocks(setup):
    """submit_group: [B, n, T] chunks concatenate to each request's solo rows
    (pad-filled after early finishers)."""
    _, cfg, _, model = setup
    tok = cfg.tokenizer
    prompts = [bos_prompt(tok), bos_prompt(tok, 2)]
    refs = solo_reference(model, cfg, prompts, [6, 6])
    svc = BatcherService(ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3,
                                           greedy=True))
    try:
        chunks = list(svc.submit_group(prompts, max_events=6))
        assert all(c.ndim == 3 and c.shape[0] == 2 for c in chunks)
        full = np.concatenate(chunks, axis=1)
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(full[i, : len(ref)], ref)
            assert np.all(full[i, len(ref):] == tok.pad_id)
        assert all(f is not None for f in svc.last_group)
    finally:
        svc.close()


def test_group_seed_reproduces(setup):
    """A seeded group decodes every variation from its derived stream: the
    same seed gives the same blocks twice."""
    _, cfg, _, model = setup
    tok = cfg.tokenizer
    prompts = [bos_prompt(tok), bos_prompt(tok, 1)]

    def run():
        svc = BatcherService(ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=3,
                                               disable_eos=True))
        try:
            return np.concatenate(list(svc.submit_group(prompts, max_events=5, seed=9)),
                                  axis=1)
        finally:
            svc.close()

    a = run()
    assert a.shape == (2, 5, tok.max_token_seq)
    np.testing.assert_array_equal(a, run())


def test_group_rejects_oversize(setup):
    _, cfg, _, model = setup
    tok = cfg.tokenizer
    svc = BatcherService(ContinuousBatcher(model, cfg, n_slots=2, max_seq=64, chunk=2))
    try:
        with pytest.raises(ValueError, match="exceeds n_slots"):
            svc.submit_group([bos_prompt(tok)] * 3, max_events=2)
    finally:
        svc.close()


class _SlowBatcher:
    """A stand-in batcher whose every step keeps the host busy for 20 ms and
    counts itself."""

    n_slots = 4
    tokenizer = None

    def __init__(self):
        self.steps = 0
        self.any_active = True

    def submit(self, prompt_rows, max_events, **kw):
        return self.steps

    def step(self, on_rows=None):
        import time

        end = time.perf_counter() + 0.02
        while time.perf_counter() < end:  # busy, holding the GIL, as a dispatch does
            pass
        self.steps += 1
        return []


def test_lock_handed_to_waiting_submissions():
    """A submission waiting for the lock takes it before the step thread's
    next step: while it waits, at most the step in progress and one that
    began just as it arrived run (one more if the interpreter switches
    threads between its arrival and its count of waiting)."""
    import time

    class Recording(BatcherService):
        def _acquire(self, group):
            self.arrived = self.batcher.steps
            super()._acquire(group)

    batcher = _SlowBatcher()
    svc = Recording(batcher)
    try:
        time.sleep(0.1)  # the step thread is stepping
        waited = []
        for _ in range(20):
            rid, _rows = svc.submit_stream(np.zeros((1, 8), np.int64), 4)
            waited.append(rid - svc.arrived)  # steps run while this one waited
            time.sleep(0.01)
        assert max(waited) <= 3, waited
    finally:
        batcher.any_active = False
        svc.close()
