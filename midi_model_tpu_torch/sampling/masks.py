"""Static grammar-mask tables for constrained decoding (numpy only).

The counterpart of ``midi_model_tpu/sampling/masks.py``.  The whole row
grammar is precomputed once into three dense boolean tables; the decode
loop just gathers rows:

- ``first[V]``: ids allowed at step 0 (event ids + eos, minus disabled events);
- ``steps[E, T, V]``: ids allowed at step i (1..T-1) when the row's event is e
  (the i-1'th parameter's id range, or pad once the parameter list is
  exhausted; channel steps honour ``disable_channels``);
- ``pad_only[V]``: forced once a row has emitted eos.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np


class MaskTable(NamedTuple):
    first: np.ndarray  # [V] bool
    steps: np.ndarray  # [E, T, V] bool
    pad_only: np.ndarray  # [V] bool
    first_event_id: int
    n_events: int


def build_mask_table(tokenizer, disable_patch_change: bool = False,
                     disable_control_change: bool = False,
                     disable_channels: Optional[Sequence[int]] = None,
                     disable_eos: bool = False) -> MaskTable:
    v = tokenizer.vocab
    vocab = v.vocab_size
    t_max = v.max_token_seq
    tables = v.grammar_tables()
    first_event = tables["first_event_id"]
    n_events = tables["n_events"]

    first = np.zeros((vocab,), dtype=bool)
    for name in v.events:
        if disable_patch_change and name == "patch_change":
            continue
        if disable_control_change and name == "control_change":
            continue
        first[v.event_ids[name]] = True
    if not disable_eos:
        first[v.eos_id] = True

    pad_only = np.zeros((vocab,), dtype=bool)
    pad_only[v.pad_id] = True

    disabled_channel_ids = []
    if disable_channels:
        base = v.param_base("channel")
        disabled_channel_ids = [base + c for c in disable_channels]

    steps = np.zeros((n_events, t_max, vocab), dtype=bool)
    for name, eid in v.event_ids.items():
        off = eid - first_event
        params = v.events[name]
        for i in range(1, t_max):
            if i - 1 >= len(params):
                steps[off, i, v.pad_id] = True
                continue
            lo, hi = v.param_range(params[i - 1])
            steps[off, i, lo:hi] = True
            if params[i - 1] == "channel":
                steps[off, i, disabled_channel_ids] = False
    return MaskTable(first=first, steps=steps, pad_only=pad_only,
                     first_event_id=first_event, n_events=n_events)


def build_allow_vector(tokenizer, disable_patch_change: bool = False,
                       disable_control_change: bool = False,
                       disable_channels: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
    """Per-request constraint plane: a [V] bool vector with False at every
    banned id.  One multiplicative mask serves every token step because each
    ban targets an id block no other grammar position uses (event-type ids
    and channel-parameter ids are disjoint vocab ranges)."""
    v = tokenizer.vocab
    allow = np.ones((v.vocab_size,), dtype=bool)
    if disable_patch_change:
        allow[v.event_ids["patch_change"]] = False
    if disable_control_change:
        allow[v.event_ids["control_change"]] = False
    if disable_channels:
        base = v.param_base("channel")
        for c in disable_channels:
            allow[base + c] = False
    return allow
