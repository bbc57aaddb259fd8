"""Event tokenizer core: score ⇄ fixed-width token rows.

Each musical event becomes one row of ``max_token_seq`` ids:
``[event_id, param_0, param_1, ..., pad...]``.  Time is quantized to 1/16 beat
and split into an inter-beat delta (``time1``, delta-encoded across rows) and a
within-beat position (``time2``).

This single implementation serves both tokenizer versions; the differences
(event schema, note parameter order, bpm ceiling, time/key-signature support)
are declarative class attributes on the subclasses in v1.py / v2.py.

Behavioral parity with the reference (its midi_tokenizer.py) is
pinned by golden tests; the quirks worth knowing about are kept deliberately:

- python banker's rounding in quantization (ref :640);
- dict-insertion-order dedup of events, keyed on the event minus its trailing
  parameters (ref :701-704, :110-113);
- same-(channel,pitch) overlap truncation at tokenize time (ref :713-721) and
  a reverse-scan duration clamp at detokenize time (ref :982-999);
- "setup" events (patches/tempi/signatures before the first real note gap) are
  deduplicated and front-loaded at time 0 (ref :874-899);
- a first control_change with value < eps from 0 is dropped (ref :673-676);
- V1's setup-dedup key for notes ignores pitch (positional slice, ref :253).

The tokenize pipeline is organized as explicit phases:
scan/quantize → channel-remap → default-instruments → key-signature repair
(v2) → stable sort → setup front-load → delta-encode.
"""

from __future__ import annotations

import random as _random_module
from typing import Any, Dict, List, Optional

import numpy as np

from .vocab import Vocab


class EventTokenizerBase:
    """Shared machinery for MIDITokenizerV1/V2-compatible tokenizers."""

    # ---- subclass-provided schema ---------------------------------------
    version: str = ""
    EVENTS: Dict[str, List[str]] = {}
    EVENT_PARAMETERS: Dict[str, int] = {}
    BPM_MAX: int = 255
    HAS_SIGNATURES: bool = False  # time_signature / key_signature support
    EVENT_SORT_ORDER: List[str] = []
    # events whose setup/dedup keys drop the last TWO fields (positional
    # slices in the reference; note/time_signature/key_signature)
    _DROP2_KEY_EVENTS = ("note", "time_signature", "key_signature")
    # events exempt from time-zeroing during setup front-loading
    SETUP_KEEP_TIME: tuple = ("note",)

    def __init__(self):
        self.optimise_midi = False
        self.vocab = Vocab(self.EVENTS, self.EVENT_PARAMETERS)
        v = self.vocab
        # Flat aliases mirroring the reference's public attribute surface.
        self.vocab_size = v.vocab_size
        self.pad_id = v.pad_id
        self.bos_id = v.bos_id
        self.eos_id = v.eos_id
        self.events = v.events
        self.event_parameters = v.event_parameters
        self.event_ids = v.event_ids
        self.id_events = v.id_events
        self.parameter_ids = v.parameter_ids
        self.max_token_seq = v.max_token_seq
        # Field positions within a normalized record [name, t1, t2, track, *params].
        note = self.EVENTS["note"]
        self._note_ch = 1 + note.index("channel")
        self._note_pitch = 1 + note.index("pitch")
        self._note_vel = 1 + note.index("velocity")
        self._note_dur = 1 + note.index("duration")
        self._order = {n: i for i, n in enumerate(self.EVENT_SORT_ORDER)}

    # ---- config / serialization ----------------------------------------

    def set_optimise_midi(self, optimise_midi: bool = True):
        self.optimise_midi = optimise_midi

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "optimise_midi": self.optimise_midi,
            "vocab_size": self.vocab_size,
            "events": self.events,
            "event_parameters": self.event_parameters,
            "max_token_seq": self.max_token_seq,
            "pad_id": self.pad_id,
            "bos_id": self.bos_id,
            "eos_id": self.eos_id,
        }

    # ---- small music-theory helpers -------------------------------------

    @staticmethod
    def tempo2bpm(tempo: float) -> float:
        return 60.0 / (tempo / 10**6)

    @staticmethod
    def bpm2tempo(bpm: float) -> int:
        if bpm == 0:
            bpm = 1
        return int((60 / bpm) * 10**6)

    @staticmethod
    def sf2key(sf: int) -> int:
        """Circle-of-fifths signature -> root key (0=C .. 11=B)."""
        return (sf * 7) % 12

    @staticmethod
    def key2sf(k: int, mi: int) -> int:
        sf = (k * 7) % 12
        if sf > 6 or (mi == 1 and sf >= 5):
            sf -= 12
        return sf

    @staticmethod
    def detect_key_signature(key_hist: List[int], threshold: float = 0.7) -> Optional[int]:
        """Infer the root key from a pitch-class histogram.

        Picks the 7 most frequent pitch classes and requires them to contain
        exactly two semitone pairs spaced like a diatonic scale
        (parity: ref midi_tokenizer.py:582-606).
        """
        if len(key_hist) != 12 or sum(key_hist) == 0:
            return None
        covered = sum(sorted(key_hist, reverse=True)[:7]) / sum(key_hist)
        if covered < threshold:
            return None
        keys = sorted(
            k for _, k in sorted(
                zip(key_hist, range(12)), reverse=True, key=lambda x: x[0]
            )[:7]
        )
        semis = [keys[i] for i in range(len(keys)) if (keys[i] - keys[i - 1]) in (1, -11)]
        if len(semis) != 2:
            return None
        gap = semis[1] - semis[0]
        if gap == 5:
            return semis[0]
        if gap == 7:
            return semis[1]
        return None

    # ---- row codec -------------------------------------------------------

    def event2tokens(self, event: list) -> list:
        """[name, *params] -> one fixed-width id row (empty if out of range)."""
        name = event[0]
        params = event[1:]
        schema = self.events[name]
        for i, p in enumerate(schema):
            if not 0 <= params[i] < self.event_parameters[p]:
                return []
        row = [self.event_ids[name]] + [
            self.parameter_ids[p][params[i]] for i, p in enumerate(schema)
        ]
        row += [self.pad_id] * (self.max_token_seq - len(row))
        return row

    def tokens2event(self, tokens: list) -> list:
        """Inverse of event2tokens (empty list on any invalid id)."""
        eid = tokens[0]
        if eid not in self.id_events:
            return []
        name = self.id_events[eid]
        schema = self.events[name]
        if len(tokens) <= len(schema):
            return []
        params = []
        for i, p in enumerate(schema):
            val = tokens[1 + i] - self.parameter_ids[p][0]
            if not 0 <= val < self.event_parameters[p]:
                return []
            params.append(val)
        return [name] + params

    # ---- tokenize pipeline ----------------------------------------------

    def tokenize(self, midi_score: list, add_bos_eos: bool = True, cc_eps: int = 4,
                 tempo_eps: int = 4, remap_track_channel: Optional[bool] = None,
                 add_default_instr: Optional[bool] = None,
                 remove_empty_channels: Optional[bool] = None) -> list:
        if remap_track_channel is None:
            remap_track_channel = self.optimise_midi
        if add_default_instr is None:
            add_default_instr = self.optimise_midi
        if remove_empty_channels is None:
            remove_empty_channels = self.optimise_midi

        st = _ScanState()
        native = _native_scan()
        if native is not None:
            event_list = self._scan_tracks_native(native, midi_score, st,
                                                  cc_eps, tempo_eps)
        else:
            self._scan_tracks(midi_score, st, cc_eps, tempo_eps)
            event_list = list(st.event_list.values())
        st.empty_channels = [c for c in st.channels if st.empty_flags[c]]

        if remap_track_channel:
            event_list = self._remap_track_channel(event_list, st, remove_empty_channels)

        if add_default_instr:
            for c in st.channels:
                if c not in st.patch_channels and c in st.track_idx_dict:
                    event_list.append(["patch_change", 0, 0, st.track_idx_dict[c], c, 0])

        if self.HAS_SIGNATURES:
            event_list = self._repair_key_signatures(event_list, st, remap_track_channel)

        event_list = sorted(event_list, key=self._sort_key)
        event_list = self._frontload_setup(event_list)

        midi_seq = self._delta_encode(event_list, remove_empty_channels, st.empty_channels)

        if add_bos_eos:
            bos = [self.bos_id] + [self.pad_id] * (self.max_token_seq - 1)
            eos = [self.eos_id] + [self.pad_id] * (self.max_token_seq - 1)
            midi_seq = [bos] + midi_seq + [eos]
        return midi_seq

    def _sort_key(self, e: list):
        return e[1:4] + [self._order[e[0]]]

    def _record_key(self, name: str, rec: list) -> tuple:
        """Dedup key: the record minus its trailing 'payload' fields."""
        if name == "note":
            # (name, t1, t2, track, channel, pitch)
            return ("note", rec[1], rec[2], rec[3], rec[self._note_ch], rec[self._note_pitch])
        if name in ("time_signature", "key_signature"):
            return tuple(rec[:-2])
        return tuple(rec[:-1])

    def _scan_tracks_native(self, native, midi_score: list, st: "_ScanState",
                            cc_eps: float, tempo_eps: float) -> list:
        """Phase 1 via the C++ extension (native/tokenizer_scan.cpp); fills
        the same _ScanState the python scan produces and returns the live
        event list (key_sigs alias the same record objects)."""
        out = native.scan_tracks(midi_score, 1 if self.version == "v1" else 2,
                                 float(cc_eps), float(tempo_eps))
        st.channels = out["channels"]
        st.patch_channels = out["patch_channels"]
        st.empty_flags = out["empty_flags"]
        st.track_idx_dict = out["track_idx_dict"]
        st.track_idx_map = out["track_idx_map"]
        st.channel_note_tracks = out["channel_note_tracks"]
        st.note_key_hist = out["note_key_hist"]
        st.key_sigs = out["key_sigs"]
        st.track_to_channels = out["track_to_channels"]
        return out["event_list"]

    def _scan_tracks(self, midi_score: list, st: "_ScanState", cc_eps: int, tempo_eps: int):
        """Phase 1: quantize, validate, dedup; build channel/track indexes."""
        tpb = midi_score[0]
        for track_idx, track in enumerate(midi_score[1:129]):
            last_notes: dict = {}
            patch_seen: dict = {}
            cc_seen: dict = {}
            last_bpm = 0
            track_channels: list = []
            st.track_to_channels.setdefault(track_idx, track_channels)
            for event in track:
                name = event[0]
                if name not in self.events:
                    continue
                c = -1
                t = round(16 * event[1] / tpb)
                rec = [name, t // 16, t % 16, track_idx]

                if name == "note":
                    d, c, p, v = event[2], event[3], event[4], event[5]
                    if not 0 <= c <= 15:
                        continue
                    d = max(1, round(16 * d / tpb))
                    vals = {"duration": d, "channel": c, "pitch": p, "velocity": v}
                    rec += [vals[pn] for pn in self.events["note"][3:]]
                    st.empty_flags[c] = False
                    st.track_idx_dict.setdefault(c, track_idx)
                    note_tracks = st.channel_note_tracks[c]
                    if track_idx not in note_tracks:
                        note_tracks.append(track_idx)
                    if c != 9:
                        st.note_key_hist[p % 12] += 1
                    if c not in track_channels:
                        track_channels.append(c)
                elif name == "patch_change":
                    c, p = event[2], event[3]
                    if not 0 <= c <= 15:
                        continue
                    rec += [c, p]
                    if patch_seen.setdefault(c, None) == p:
                        continue
                    patch_seen[c] = p
                    if c not in st.patch_channels:
                        st.patch_channels.append(c)
                elif name == "control_change":
                    c, cc, v = event[2], event[3], event[4]
                    if not 0 <= c <= 15:
                        continue
                    rec += [c, cc, v]
                    if abs(cc_seen.setdefault((c, cc), 0) - v) < cc_eps:
                        continue
                    cc_seen[(c, cc)] = v
                elif name == "set_tempo":
                    tempo = event[2]
                    if tempo == 0:
                        continue
                    bpm = min(int(self.tempo2bpm(tempo)), self.BPM_MAX)
                    rec += [bpm]
                    if abs(last_bpm - bpm) < tempo_eps:
                        continue
                    last_bpm = bpm
                elif name == "time_signature":
                    nn, dd = event[2], event[3]
                    if not (1 <= nn <= 16 and 1 <= dd <= 4):
                        continue
                    rec += [nn - 1, dd - 1]
                elif name == "key_signature":
                    sf, mi = event[2], event[3]
                    if not (-7 <= sf <= 7 and 0 <= mi <= 1):
                        continue
                    rec += [sf + 7, mi]
                    st.key_sigs.append(rec)

                key = self._record_key(name, rec)

                if c != -1:
                    if c not in st.channels:
                        st.channels.append(c)
                    st.track_idx_map[c].setdefault(track_idx, 0)

                if name == "note":
                    # Clamp the previous same-(channel,pitch) note so quantized
                    # notes never overlap; drop it if clamped to zero length.
                    cp = (rec[self._note_ch], rec[self._note_pitch])
                    if cp in last_notes:
                        prev_key, prev = last_notes[cp]
                        prev_t = prev[1] * 16 + prev[2]
                        prev[self._note_dur] = max(0, min(prev[self._note_dur], t - prev_t))
                        if prev[self._note_dur] == 0:
                            st.event_list.pop(prev_key)
                    last_notes[cp] = (key, rec)
                st.event_list[key] = rec

    def _remap_track_channel(self, event_list: list, st: "_ScanState",
                             remove_empty_channels: bool) -> list:
        """Phase 2: compact channels (drums stay on 9) and renumber tracks so
        each channel's tracks are contiguous and note-bearing tracks come first
        (parity: ref midi_tokenizer.py:727-836)."""
        st.patch_channels = []
        channels_map: dict = {9: 9} if 9 in st.channels else {}
        channels = st.channels
        if remove_empty_channels:
            channels = sorted(channels, key=lambda x: 1 if x in st.empty_channels else 0)
        count = 0
        for c in channels:
            if c == 9:
                continue
            channels_map[c] = count
            count += 1
            if count == 9:
                count = 10
        st.channels = list(channels_map.values())

        track_count = 0
        order = [k for k, _ in sorted(channels_map.items(), key=lambda kv: kv[1])]
        for c in order:  # tracks that survive
            if remove_empty_channels and c in st.empty_channels:
                continue
            note_tracks = st.channel_note_tracks[c]
            for track_idx in st.track_idx_map[c]:
                if note_tracks and track_idx not in note_tracks:
                    continue
                track_count += 1
                st.track_idx_map[c][track_idx] = track_count
        for c in order:  # tracks on channels being removed
            if not (remove_empty_channels and c in st.empty_channels):
                continue
            note_tracks = st.channel_note_tracks[c]
            for track_idx in st.track_idx_map[c]:
                if not (note_tracks and track_idx not in note_tracks):
                    continue
                track_count += 1
                st.track_idx_map[c][track_idx] = track_count

        st.empty_channels = [channels_map[c] for c in st.empty_channels]
        st.track_idx_dict = {}
        st.key_sigs = []
        ks_to_add: list = []
        ks_to_remove: list = []
        for rec in event_list:
            name = rec[0]
            track_idx = rec[3]
            if name == "note":
                c = rec[self._note_ch]
                rec[self._note_ch] = channels_map[c]
                rec[3] = st.track_idx_map[c][track_idx]
                st.track_idx_dict.setdefault(rec[self._note_ch], rec[3])
            elif name in ("set_tempo", "time_signature"):
                rec[3] = 0  # meta events live on track 0
            elif name == "key_signature":
                self._remap_key_signature(rec, track_idx, st, channels_map,
                                          ks_to_add, ks_to_remove)
            elif name in ("control_change", "patch_change"):
                c = rec[4]
                rec[4] = channels_map[c]
                note_tracks = st.channel_note_tracks[c]
                if note_tracks and track_idx not in note_tracks:
                    track_idx = note_tracks[0]  # move to a note-bearing track
                rec[3] = st.track_idx_map[c][track_idx]
                if name == "patch_change" and rec[4] not in st.patch_channels:
                    st.patch_channels.append(rec[4])
        for ks in ks_to_remove:
            event_list.remove(ks)
        event_list += ks_to_add

        st.track_to_channels = {}
        for c, tr_map in st.track_idx_map.items():
            if c not in channels_map:
                continue
            nc = channels_map[c]
            for new_track in tr_map.values():
                cs = st.track_to_channels.setdefault(new_track, [])
                if nc not in cs:
                    cs.append(nc)
        return event_list

    def _remap_key_signature(self, rec: list, track_idx: int, st: "_ScanState",
                             channels_map: dict, ks_to_add: list, ks_to_remove: list):
        """Duplicate a key_signature across every remapped track that inherited
        events from its original track; force sf=0 on drum tracks."""
        targets = []
        for c, tr_map in st.track_idx_map.items():
            if track_idx in tr_map:
                new_track = tr_map[track_idx]
                nc = channels_map[c]
                if new_track == 0:
                    continue
                if (nc, new_track) not in targets:
                    targets.append((nc, new_track))
        if not targets:
            if rec[3] == 0:  # keep meta-track key signatures
                st.key_sigs.append(rec)
                return
            rec[3] = -1  # make the record unique so list.remove is precise
            ks_to_remove.append(rec)
            return
        c, nt = targets[0]
        rec[3] = nt
        st.key_sigs.append(rec)
        if c == 9:
            rec[4] = 7  # sf = 0 for drums
        for c, nt in targets[1:]:
            dup = [*rec]
            dup[3] = nt
            if c == 9:
                dup[4] = 7
            st.key_sigs.append(dup)
            ks_to_add.append(dup)

    def _repair_key_signatures(self, event_list: list, st: "_ScanState",
                               remapped: bool) -> list:
        """Phase 4 (v2): detect the key from the pitch histogram when key
        signatures are missing or all-default; drop them when undetectable
        (parity: ref midi_tokenizer.py:843-867)."""
        if st.key_sigs and not all(ks[4] == 7 for ks in st.key_sigs):
            return event_list
        root_key = self.detect_key_signature(st.note_key_hist)
        if root_key is not None:
            sf = self.key2sf(root_key, 0)
            if not st.key_sigs:
                for tr, cs in st.track_to_channels.items():
                    if remapped and tr == 0:
                        continue
                    drum_only = len(cs) == 1 and cs[0] == 9
                    event_list.append(
                        ["key_signature", 0, 0, tr, (0 if drum_only else sf) + 7, 0])
            else:
                for ks in st.key_sigs:
                    cs = st.track_to_channels.get(ks[3])
                    if cs is not None and len(cs) == 1 and cs[0] == 9:
                        continue
                    ks[4] = sf + 7
                    ks[5] = 0
        else:
            for ks in st.key_sigs:
                event_list.remove(ks)
        return event_list

    def _frontload_setup(self, event_list: list) -> list:
        """Phase 6: move the pre-music setup block (patches/tempi/signatures,
        plus any notes sounding at the very first instant) to time zero,
        deduplicated (parity: ref midi_tokenizer.py:874-899)."""
        setup: dict = {}
        notes_in_setup = False
        for i, event in enumerate(event_list):
            new_event = [*event]
            if event[0] not in self.SETUP_KEEP_TIME:
                new_event[1] = 0
                new_event[2] = 0
            has_next = (
                i < len(event_list) - 1
                and event[1] + event[2] == event_list[i + 1][1] + event_list[i + 1][2]
            )
            has_pre = (
                notes_in_setup and i > 0
                and event[1] + event[2] == event_list[i - 1][1] + event_list[i - 1][2]
            )
            if (event[0] == "note" and not has_next) or (notes_in_setup and not has_pre):
                return sorted(setup.values(), key=self._sort_key) + event_list[i:]
            if event[0] == "note":
                notes_in_setup = True
            if event[0] in self._DROP2_KEY_EVENTS:
                key = tuple([event[0]] + event[3:-2])
            else:
                key = tuple([event[0]] + event[3:-1])
            setup[key] = new_event
        return event_list

    def _delta_encode(self, event_list: list, remove_empty_channels: bool,
                      empty_channels: list) -> list:
        """Phase 7: delta-encode time1 across rows and emit token rows."""
        last_t1 = 0
        midi_seq = []
        for event in event_list:
            if (remove_empty_channels
                    and event[0] in ("control_change", "patch_change")
                    and event[4] in empty_channels):
                continue
            cur_t1 = event[1]
            event[1] = event[1] - last_t1
            tokens = self.event2tokens(event)
            if not tokens:
                continue
            midi_seq.append(tokens)
            last_t1 = cur_t1
        return midi_seq

    # ---- detokenize ------------------------------------------------------

    def detokenize(self, midi_seq: list) -> list:
        """Token rows -> score at a fixed 480 ticks/quarter, with a reverse
        scan clamping overlapping same-(channel,pitch) notes."""
        tpq = 480
        tracks_dict: dict = {}
        t1 = 0
        for tokens in midi_seq:
            if tokens[0] not in self.id_events:
                continue
            event = self.tokens2event(tokens)
            if not event:
                continue
            t1 += event[1]
            t = int((t1 * 16 + event[2]) * tpq / 16)
            score_event = self._detok_event(event, t, tpq)
            if score_event is None:
                continue
            tracks_dict.setdefault(event[3], []).append(score_event)
        tracks = [tr for _, tr in sorted(tracks_dict.items(), key=lambda kv: kv[0])]

        for i, track in enumerate(tracks):
            track = sorted(track, key=lambda e: e[1])
            last_start: dict = {}
            dropped = []
            for e in reversed(track):
                if e[0] == "note":
                    t, d, c, p = e[1], e[2], e[3], e[4]
                    if (c, p) in last_start:
                        d = min(d, max(last_start[(c, p)] - t, 0))
                    last_start[(c, p)] = t
                    e[2] = d
                    if d == 0:
                        dropped.append(e)
            for e in dropped:
                track.remove(e)
            tracks[i] = track
        return [tpq, *tracks]

    def _detok_event(self, event: list, t: int, tpq: int) -> Optional[list]:
        """One decoded event record -> a score event (None to drop)."""
        name = event[0]
        if name == "note":
            vals = dict(zip(self.events["note"][3:], event[4:]))
            return ["note", t, int(vals["duration"] * tpq / 16),
                    vals["channel"], vals["pitch"], vals["velocity"]]
        if name in ("control_change", "patch_change"):
            return [name, t] + event[4:]
        if name == "set_tempo":
            return [name, t, self.bpm2tempo(event[4])]
        if name == "time_signature":
            return [name, t, event[4] + 1, event[5] + 1, 24, 8]
        if name == "key_signature":
            return [name, t, event[4] - 7, event[5]]
        return None

    # ---- augmentation ----------------------------------------------------

    def augment(self, midi_seq: list, max_pitch_shift: int = 4, max_vel_shift: int = 10,
                max_cc_val_shift: int = 10, max_bpm_shift: int = 10,
                max_track_shift: int = 0, max_channel_shift: int = 16,
                rng=None) -> list:
        """Random transposition / velocity / cc / bpm / track / channel shifts.

        Draws from ``rng`` (default: the global ``random`` module, matching the
        reference) in a fixed order so seeded runs are reproducible.
        """
        rng = rng or _random_module
        pitch_shift = rng.randint(-max_pitch_shift, max_pitch_shift)
        vel_shift = rng.randint(-max_vel_shift, max_vel_shift)
        cc_val_shift = rng.randint(-max_cc_val_shift, max_cc_val_shift)
        bpm_shift = rng.randint(-max_bpm_shift, max_bpm_shift)
        track_shift = rng.randint(0, max_track_shift)
        channel_shift = rng.randint(0, max_channel_shift)

        pid = self.parameter_ids
        out = []
        key_sig_rows = []
        track_to_channels: dict = {}
        for tokens in midi_seq:
            row = [*tokens]
            if tokens[0] in self.id_events:
                name = self.id_events[tokens[0]]
                for i, pn in enumerate(self.events[name]):
                    if pn == "track":
                        tr = (tokens[1 + i] - pid[pn][0] + track_shift) % self.event_parameters[pn]
                        row[1 + i] = pid[pn][tr]
                    elif pn == "channel":
                        c0 = tokens[1 + i] - pid[pn][0]
                        c = (c0 + channel_shift) % self.event_parameters[pn]
                        if c0 == 9:
                            c = 9  # drums stay on channel 9
                        elif c == 9:
                            c = (9 + channel_shift) % self.event_parameters[pn]
                        row[1 + i] = pid[pn][c]

                if name == "note":
                    note_schema = self.events["note"]
                    tr = tokens[3] - pid["track"][0]
                    c = tokens[1 + note_schema.index("channel")] - pid["channel"][0]
                    p = tokens[1 + note_schema.index("pitch")] - pid["pitch"][0]
                    v = tokens[1 + note_schema.index("velocity")] - pid["velocity"][0]
                    if c != 9:
                        p += pitch_shift
                    if not 0 <= p < 128:
                        return midi_seq  # transposition fell off the keyboard
                    v = max(1, min(127, v + vel_shift))
                    row[1 + note_schema.index("pitch")] = pid["pitch"][p]
                    row[1 + note_schema.index("velocity")] = pid["velocity"][v]
                    cs = track_to_channels.setdefault(tr, [])
                    if c not in cs:
                        cs.append(c)
                elif name == "control_change":
                    cc = tokens[1 + self.events[name].index("controller")] - pid["controller"][0]
                    val = tokens[1 + self.events[name].index("value")] - pid["value"][0]
                    if cc in (1, 2, 7, 11):  # expression-like controllers
                        val = max(1, min(127, val + cc_val_shift))
                    row[1 + self.events[name].index("value")] = pid["value"][val]
                elif name == "set_tempo":
                    bpm = tokens[4] - pid["bpm"][0]
                    bpm = max(1, min(self.BPM_MAX, bpm + bpm_shift))
                    row[4] = pid["bpm"][bpm]
                elif name == "key_signature":
                    sf = tokens[4] - pid["sf"][0] - 7
                    mi = tokens[5] - pid["mi"][0]
                    k = (self.sf2key(sf) + pitch_shift) % 12
                    sf = self.key2sf(k, mi) + 7
                    row[4] = pid["sf"][sf]
                    row[5] = pid["mi"][mi]
                    key_sig_rows.append(row)
            out.append(row)
        # Key signatures on drum-only tracks are forced back to sf=0.
        for row in key_sig_rows:
            tr = row[3] - pid["track"][0]
            cs = track_to_channels.get(tr)
            if cs is not None and len(cs) == 1 and cs[0] == 9:
                row[4] = pid["sf"][7]
        return out

    # ---- corpus quality filter ------------------------------------------

    def check_quality(self, midi_seq: list, alignment_min: float = 0.3,
                      tonality_min: float = 0.8, piano_max: float = 0.7,
                      notes_bandwidth_min: int = 3, notes_density_max: int = 50,
                      notes_density_min: float = 2.5, total_notes_max: int = 20000,
                      total_notes_min: int = 256, note_window_size: int = 16):
        """Heuristic corpus filter; returns (ok, [reasons]).

        Parity: ref midi_tokenizer.py:1104-1186 — checks note count, beat
        alignment, tonality, chord bandwidth, note density and piano ratio.
        """
        note_schema = self.events["note"][3:]
        total_notes = 0
        channels: list = []
        time_hist = [0] * 16
        note_windows: dict = {}
        notes_sametime: list = []
        notes_density_list: list = []
        tonality_list: list = []
        notes_bandwidth_list: list = []
        instruments: dict = {}
        piano_channels: list = []
        abs_t1 = 0
        last_t = 0
        for tokens in midi_seq:
            event = self.tokens2event(tokens)
            if not event:
                continue
            t1, t2 = event[1], event[2]
            abs_t1 += t1
            t = abs_t1 * 16 + t2
            c = None
            if event[0] == "note":
                vals = dict(zip(note_schema, event[4:]))
                c, p, d = vals["channel"], vals["pitch"], vals["duration"]
                total_notes += 1
                time_hist[t2] += 1
                if c != 9:
                    if c not in instruments:
                        instruments[c] = 0
                        if c not in piano_channels:
                            piano_channels.append(c)
                    note_windows.setdefault(abs_t1 // note_window_size, []).append(p)
                if last_t != t:
                    notes_sametime = [(et, p_) for et, p_ in notes_sametime if et > last_t]
                    ps = [p_ for _, p_ in notes_sametime]
                    if notes_sametime:
                        notes_bandwidth_list.append(max(ps) - min(ps))
                notes_sametime.append((t + d - 1, p))
            elif event[0] == "patch_change":
                c, p = event[4], event[5]
                instruments[c] = p
                if p == 0 and c not in piano_channels:
                    piano_channels.append(c)
            if c is not None and c not in channels:
                channels.append(c)
            last_t = t

        reasons = []
        if total_notes < total_notes_min:
            reasons.append("total_min")
        if total_notes > total_notes_max:
            reasons.append("total_max")
        if len(note_windows) == 0 and total_notes > 0:
            reasons.append("drum_only")
        if reasons:
            return False, reasons

        time_hist = sorted(time_hist, reverse=True)
        alignment = sum(time_hist[:2]) / total_notes
        for notes in note_windows.values():
            key_hist = [0] * 12
            for p in notes:
                key_hist[p % 12] += 1
            key_hist = sorted(key_hist, reverse=True)
            tonality_list.append(sum(key_hist[:7]) / len(notes))
            notes_density_list.append(len(notes) / note_window_size)
        tonality_list = sorted(tonality_list)
        tonality = sum(tonality_list) / len(tonality_list)
        bandwidth = (sum(notes_bandwidth_list) / len(notes_bandwidth_list)
                     if notes_bandwidth_list else 0)
        density = max(notes_density_list) if notes_density_list else 0
        piano_ratio = len(piano_channels) / len(channels)
        if len(channels) <= 3:  # piano solos are exempt from the piano cap
            piano_max = 1
        if alignment < alignment_min:
            reasons.append("alignment")
        if tonality < tonality_min:
            reasons.append("tonality")
        if bandwidth < notes_bandwidth_min:
            reasons.append("bandwidth")
        if not notes_density_min < density < notes_density_max:
            reasons.append("density")
        if piano_ratio > piano_max:
            reasons.append("piano")
        return not reasons, reasons

    # ---- visualization ---------------------------------------------------

    def midi2img(self, midi_score: list):
        """Piano-roll PNG of a score (random per-(track,channel) colors)."""
        import PIL.Image

        tpb = midi_score[0]
        notes = []
        max_time = 1
        track_num = len(midi_score[1:])
        for track_idx, track in enumerate(midi_score[1:]):
            for event in track:
                t = round(16 * event[1] / tpb)
                if event[0] == "note":
                    d = max(1, round(16 * event[2] / tpb))
                    c, p = event[3], event[4]
                    max_time = max(max_time, t + d + 1)
                    notes.append((track_idx, c, p, t, d))
        img = np.zeros((128, max_time, 3), dtype=np.uint8)
        colors = {(i, j): np.random.randint(50, 256, 3)
                  for i in range(track_num) for j in range(16)}
        for tr, c, p, t, d in notes:
            img[p, t: t + d] = colors[(tr, c)]
        return PIL.Image.fromarray(np.flip(img, 0))


def _native_scan():
    """The optional C++ scan-phase module (native/tokenizer_scan.cpp), or
    None where it does not build: then the Python scan runs."""
    from ..native import native_tokenizer_scan

    return native_tokenizer_scan()


class _ScanState:
    """Mutable indexes accumulated while scanning tracks."""

    def __init__(self):
        self.event_list: dict = {}  # dedup key -> normalized record
        self.track_idx_map = {i: dict() for i in range(16)}  # channel -> {track: new_track}
        self.track_idx_dict: dict = {}  # channel -> first note-bearing track
        self.channels: list = []  # channels seen, in first-seen order
        self.patch_channels: list = []
        self.empty_flags = [True] * 16  # channel -> has no notes
        self.empty_channels: list = []
        self.channel_note_tracks = {i: list() for i in range(16)}
        self.note_key_hist = [0] * 12
        self.key_sigs: list = []
        self.track_to_channels: dict = {}
