"""Serving front for the continuous batcher: one shared batch, many clients.

Counterpart of ``midi_model_tpu/serve/batcher_service.py`` (its logic is
framework-free and is kept as it is).  Concurrent sessions become slot
admissions into one running
:class:`~midi_model_tpu_torch.serve.batcher.ContinuousBatcher`: a
background thread drives ``step()`` whenever any slot is live, and every
request streams its freshly decoded rows through its own queue as they
land.  Requests carry their own sampling knobs and grammar constraints
(per-slot planes in the decode kernels), so sessions with different
sliders / instrument bans share one device batch.

Thread discipline: ONE lock guards the batcher (submission mutates device
state via prefill + splice; step advances it).  ``submit*`` and the step
thread both take it, so a registration is never racing a delivery.  The
step thread hands the lock over: between two steps it lets every
submission already waiting take the lock first (a plain lock let the
thread that had just released it take it again at once, so a submission
waited several chunks by chance).

Recorder spans (``utils.profiling``): ``service.lock_wait`` (a submission
waiting for the lock), ``service.submit`` (the lock held for its
``batcher.submit`` calls) and ``service.idle`` (the step thread asleep
with nothing active, until its next wake).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import profiling
from .batcher import ContinuousBatcher, Finished


class BatcherService:
    """Background-stepped batcher with per-request streaming queues."""

    def __init__(self, batcher: ContinuousBatcher):
        self.batcher = batcher
        self._lock = threading.Lock()
        # submissions waiting for the lock, under ``_turn``
        self._waiting = 0
        self._turn = threading.Condition()
        self._wake = threading.Event()
        self._streams: Dict[int, queue.Queue] = {}
        self.results: Dict[int, Finished] = {}
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="batcher-step")
        self._thread.start()

    # ---- submission ------------------------------------------------------

    def submit_stream(self, prompt_rows, max_events: int, **submit_kw):
        """Submit one request; returns ``(request_id, row_iterator)``.

        The iterator yields ``[n, T]`` numpy blocks as they decode and ends
        when the request finishes; ``submit_kw`` passes through to
        :meth:`ContinuousBatcher.submit` (per-request temp/top_p/top_k and
        ``disable_*`` grammar constraints).
        """
        q: queue.Queue = queue.Queue()
        self._acquire(1)
        try:
            with profiling.span("service.submit") as sp:
                rid = self.batcher.submit(prompt_rows, max_events, **submit_kw)
                self._streams[rid] = q
                if sp:
                    sp.attrs["rids"] = [rid]
        finally:
            self._lock.release()
        self._wake.set()

        def drain():
            while True:
                _rid, kind, payload = q.get()
                if kind == "rows":
                    yield payload
                else:
                    return

        return rid, drain()

    def submit_group(self, prompts: Sequence[np.ndarray], max_events: int,
                     **submit_kw):
        """Submit a batch of requests that stream as ONE aligned block
        sequence (the UI's B simultaneous variations).

        Returns a generator of ``[B, n, T]`` chunks; rows of requests that
        finished early are pad-filled (matching the aligned ``generate``,
        whose ended rows keep emitting pad rows).  After exhaustion,
        ``last_group`` holds each request's :class:`Finished`.

        A ``seed`` kwarg seeds the GROUP: variation row ``i`` decodes from
        the derived stream ``SeedSequence([seed, i])``, so a seeded UI run
        reproduces all B variations (serve/app.py ``req.seed``).
        """
        if len(prompts) > self.batcher.n_slots:
            raise ValueError(
                f"group of {len(prompts)} exceeds n_slots="
                f"{self.batcher.n_slots}")
        group_seed = submit_kw.pop("seed", None)
        gq: queue.Queue = queue.Queue()
        idx_of: Dict[int, int] = {}
        self._acquire(len(prompts))
        try:
            with profiling.span("service.submit") as sp:
                for i, p in enumerate(prompts):
                    kw = submit_kw
                    if group_seed is not None:
                        kw = dict(submit_kw, seed=int(np.random.SeedSequence(
                            [int(group_seed), i]).generate_state(1)[0]))
                    rid = self.batcher.submit(p, max_events, **kw)
                    idx_of[rid] = i
                    self._streams[rid] = gq
                if sp:
                    sp.attrs["rids"] = list(idx_of)
        finally:
            self._lock.release()
        self._wake.set()
        return self._drain_group(gq, idx_of, max_events)

    def _acquire(self, group: int):
        """Take the lock, recorded as ``service.lock_wait`` for a
        submission of ``group`` requests; counted as waiting meanwhile, so
        the step thread lets it in before its next step."""
        with profiling.span("service.lock_wait") as sp:
            if sp:
                sp.attrs["group"] = group
            with self._turn:
                self._waiting += 1
            self._lock.acquire()
            with self._turn:
                self._waiting -= 1
                if not self._waiting:
                    self._turn.notify_all()

    def _drain_group(self, gq, idx_of, max_events: int):
        n = len(idx_of)
        tok = self.batcher.tokenizer
        t_max = tok.max_token_seq
        pad_row = np.full((t_max,), tok.pad_id, np.int32)
        bufs: List[List[np.ndarray]] = [[] for _ in range(n)]
        fins: List[Optional[Finished]] = [None] * n
        emitted = 0
        n_done = 0
        while n_done < n:
            items = [gq.get()]
            try:  # drain greedily: one device step delivers many messages
                while True:
                    items.append(gq.get_nowait())
            except queue.Empty:
                pass
            for rid, kind, payload in items:
                i = idx_of[rid]
                if kind == "rows":
                    bufs[i].extend(np.asarray(payload))
                else:
                    fins[i] = payload
                    n_done += 1
            live = [len(bufs[i]) for i in range(n) if fins[i] is None]
            target = min(live) if live else max(len(b) for b in bufs)
            target = min(target, max_events)
            if target > emitted:
                block = np.stack([
                    np.stack(bufs[i][emitted:target]
                             + [pad_row] * (target - max(emitted, len(bufs[i]))))
                    if len(bufs[i]) > emitted
                    else np.tile(pad_row, (target - emitted, 1))
                    for i in range(n)
                ])
                emitted = target
                yield block
        final = max(len(b) for b in bufs)
        if final > emitted:
            block = np.stack([
                np.stack((bufs[i][emitted:final] if len(bufs[i]) > emitted
                          else [])
                         + [pad_row] * (final - max(emitted, len(bufs[i]))))
                for i in range(n)
            ])
            yield block
        self.last_group = fins

    # ---- step thread -----------------------------------------------------

    def _on_rows(self, rid: int, rows: np.ndarray):
        q = self._streams.get(rid)
        if q is not None:
            q.put((rid, "rows", rows))

    def _loop(self):
        idle = profiling.NULL
        while True:
            woken = self._wake.wait(timeout=0.2)
            if self._stop:
                return
            if woken:
                idle.finish()
                idle = profiling.NULL
            with self._turn:  # the submissions already waiting go first
                self._turn.wait_for(lambda: not self._waiting or self._stop, timeout=1.0)
            with self._lock:
                if not self.batcher.any_active:
                    self._wake.clear()
                    if not idle:
                        idle = profiling.span("service.idle")
                    continue
                finished = self.batcher.step(on_rows=self._on_rows)
                for fin in finished:
                    self.results[fin.request_id] = fin
                    q = self._streams.pop(fin.request_id, None)
                    if q is not None:
                        q.put((fin.request_id, "done", fin))

    def close(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)
