"""Which token ids a row may hold at each of its positions: upstream's
tokenizer (``midi_tokenizer.py`` ``MIDITokenizerV2``) and its generation
masks (``midi_model.py`` ``generate``).

Ids: pad, bos, eos, then one id per event name, then one contiguous block
per parameter in the order the configuration lists them.  A row is an event
id followed by that event's parameters in order, then pad.  Generation
allows at position 0 every event id (and eos unless disabled), and at
position i the id block of the event's parameter i-1 (pad past its last);
a request's channel bans remove those channel ids."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Grammar:
    def __init__(self, tokenizer: dict):
        self.pad_id, self.bos_id, self.eos_id = (tokenizer["pad_id"], tokenizer["bos_id"],
                                                 tokenizer["eos_id"])
        events = tokenizer["events"]
        params = tokenizer["event_parameters"]
        next_id = 3
        self.event_ids = {}
        for name in events:
            self.event_ids[name] = next_id
            next_id += 1
        self.param_range = {}
        for name, size in params.items():
            self.param_range[name] = (next_id, next_id + size)
            next_id += size
        self.vocab_size = next_id
        self.row = max(len(p) for p in events.values()) + 1
        self.first_event = min(self.event_ids.values())
        self.n_events = len(events)
        # steps[e, i]: the ids allowed at position i of a row of event e
        self.steps = np.zeros((self.n_events, self.row, self.vocab_size), bool)
        for name, eid in self.event_ids.items():
            for i in range(1, self.row):
                if i - 1 < len(events[name]):
                    lo, hi = self.param_range[events[name][i - 1]]
                    self.steps[eid - self.first_event, i, lo:hi] = True
                else:
                    self.steps[eid - self.first_event, i, self.pad_id] = True
        self.steps[:, 0, self.first_event:self.first_event + self.n_events] = True

    def allowed(self, rows: np.ndarray, disable_eos: bool = True,
                disable_channels: Optional[Sequence[int]] = None) -> np.ndarray:
        """rows [N, T] -> bool [N, T, V]: the ids generation allows at each
        position given the row's event id (position 0 as for any row).  A
        row whose first id is no event id allows nothing after it."""
        ev = rows[:, 0].astype(np.int64) - self.first_event
        ok = (ev >= 0) & (ev < self.n_events)
        out = self.steps[np.clip(ev, 0, self.n_events - 1)].copy()
        out[~ok, 1:] = False
        out[:, 0] = self.steps[0, 0]
        if not disable_eos:
            out[:, 0, self.eos_id] = True
        if disable_channels:
            lo, _ = self.param_range["channel"]
            out[:, 1:, [lo + c for c in disable_channels]] = False
        return out

    def violations(self, rows: np.ndarray, disable_eos: bool = True,
                   disable_channels: Optional[Sequence[int]] = None) -> int:
        """How many tokens of rows [N, T] generation would not allow."""
        if len(rows) == 0:
            return 0
        allow = self.allowed(rows, disable_eos, disable_channels)
        n, t = rows.shape
        hit = allow[np.arange(n)[:, None], np.arange(t)[None, :], rows.astype(np.int64)]
        return int((~hit).sum())
