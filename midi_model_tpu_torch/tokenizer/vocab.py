"""Vocabulary layout for the event tokenizers.

Ids are allocated in a single contiguous space:
``pad=0, bos=1, eos=2`` followed by one id per event name, followed by one
contiguous block per parameter (parity with the reference allocator,
the reference's midi_tokenizer.py:14-34 and :512-534).

The layout is exposed both as python dicts (host-side tokenizer) and as dense
numpy tables (used to build the static grammar-mask tables the jitted sampler
consumes — see sampling/masks.py).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class Vocab:
    """Contiguous id space for one tokenizer version."""

    def __init__(self, events: Dict[str, List[str]], event_parameters: Dict[str, int]):
        self.events = events
        self.event_parameters = event_parameters

        next_id = 0

        def alloc(n: int) -> List[int]:
            nonlocal next_id
            ids = list(range(next_id, next_id + n))
            next_id += n
            return ids

        self.pad_id = alloc(1)[0]
        self.bos_id = alloc(1)[0]
        self.eos_id = alloc(1)[0]
        self.event_ids: Dict[str, int] = {name: alloc(1)[0] for name in events}
        self.id_events: Dict[int, str] = {i: name for name, i in self.event_ids.items()}
        self.parameter_ids: Dict[str, List[int]] = {
            p: alloc(size) for p, size in event_parameters.items()
        }
        self.vocab_size = next_id
        # One row per event = event id + params, padded to the widest event + 1.
        self.max_token_seq = max(len(ps) for ps in events.values()) + 1

    def param_base(self, param: str) -> int:
        return self.parameter_ids[param][0]

    def param_range(self, param: str) -> tuple:
        ids = self.parameter_ids[param]
        return ids[0], ids[0] + len(ids)

    # ---- dense tables for the on-device sampler -------------------------

    def grammar_tables(self):
        """Dense tables describing the row grammar for jitted decoding.

        Returns a dict of numpy arrays, all indexed by event id (vocab-sized
        rows are avoided; the event axis is ``n_events`` in event-id order):

        - ``event_id_lo/hi``: the contiguous range of event ids.
        - ``n_params[e]``: number of parameters of event e (by event id offset).
        - ``param_lo[e, i] / param_hi[e, i]``: allowed id range (half-open) for
          step i+1 of a row whose first token is event e; pad-only steps have
          lo=pad_id, hi=pad_id+1.
        """
        n_events = len(self.events)
        max_params = self.max_token_seq - 1
        first_event = min(self.event_ids.values())
        n_params = np.zeros((n_events,), dtype=np.int32)
        param_lo = np.full((n_events, max_params), self.pad_id, dtype=np.int32)
        param_hi = np.full((n_events, max_params), self.pad_id + 1, dtype=np.int32)
        for name, eid in self.event_ids.items():
            off = eid - first_event
            params = self.events[name]
            n_params[off] = len(params)
            for i, p in enumerate(params):
                lo, hi = self.param_range(p)
                param_lo[off, i] = lo
                param_hi[off, i] = hi
        return {
            "first_event_id": first_event,
            "n_events": n_events,
            "n_params": n_params,
            "param_lo": param_lo,
            "param_hi": param_hi,
        }
