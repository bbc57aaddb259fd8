"""Score/opus transformation utilities.

Functional parity with the reference's helper suite
(the reference's MIDI.py:416-923): ``to_millisecs``, ``grep``, ``timeshift``,
``segment``, ``score_type``, ``concatenate_scores``, ``merge_scores``,
``mix_scores``, ``mix_opus_tracks`` and ``score2stats``.
"""

from __future__ import annotations

import copy
from typing import Optional

from .codec import opus2score, score2opus
from .constants import EVENT_CHANNEL_INDEX, SYSEX2MIDIMODE

__all__ = [
    "play_score",
    "to_millisecs",
    "grep",
    "timeshift",
    "segment",
    "score_type",
    "concatenate_scores",
    "merge_scores",
    "mix_scores",
    "mix_opus_tracks",
    "score2stats",
]


def to_millisecs(old_opus: Optional[list] = None) -> list:
    """Recalibrate an opus to 1000 ticks/quarter at fixed 1 s/quarter tempo.

    Tempo changes anywhere in any track affect all tracks (the global tempo
    map), matching reference to_millisecs (the reference's MIDI.py:416-479).
    """
    if old_opus is None:
        return [1000, []]
    try:
        old_tpq = int(old_opus[0])
    except IndexError:
        return [1000, []]

    # Build the global tempo map keyed by absolute tick.
    ticks2tempo: dict = {}
    for track in old_opus[1:]:
        now = 0
        for ev in track:
            if ev[0] == "note":
                raise TypeError("to_millisecs needs an opus, not a score")
            now += ev[1]
            if ev[0] == "set_tempo":
                ticks2tempo[now] = ev[2]
    tempo_ticks = sorted(ticks2tempo)

    new_opus: list = [1000]
    for track in old_opus[1:]:
        ms_per_tick = 500.0 / old_tpq  # default 120 bpm until first set_tempo
        tempo_idx = 0
        ticks_so_far = 0
        ms_so_far = 0.0
        prev_ms = 0.0
        new_track: list = [["set_tempo", 0, 1000000]]
        for ev in track:
            delta = ev[1]
            # Apply any tempo change that falls strictly before this event.
            if tempo_idx < len(tempo_ticks) and tempo_ticks[tempo_idx] < ticks_so_far + ev[1]:
                pre = tempo_ticks[tempo_idx] - ticks_so_far
                ms_so_far += ms_per_tick * pre
                ticks_so_far = tempo_ticks[tempo_idx]
                ms_per_tick = ticks2tempo[ticks_so_far] / (1000.0 * old_tpq)
                tempo_idx += 1
                delta -= pre
            new_ev = copy.deepcopy(ev)
            ms_so_far += ms_per_tick * ev[1]
            new_ev[1] = round(ms_so_far - prev_ms)
            if ev[0] != "set_tempo":
                prev_ms = ms_so_far
                new_track.append(new_ev)
            ticks_so_far += delta
        new_opus.append(new_track)
    return new_opus


def play_score(score: Optional[list] = None):
    """Pipe a score/opus into ``aplaymidi -`` (MIDI.py:515-526 parity)."""
    if score is None:
        return
    import subprocess

    from .codec import opus2midi, score2midi

    data = opus2midi(score) if score_type(score) == "opus" else score2midi(score)
    proc = subprocess.Popen(["aplaymidi", "-"], stdin=subprocess.PIPE)
    proc.stdin.write(data)
    proc.stdin.close()


def grep(score: Optional[list] = None, channels=None) -> list:
    """Keep only events on the given channels (MIDI.py:490-512)."""
    if score is None:
        return [1000, []]
    new_score: list = [score[0]]
    if channels is None:
        return new_score
    channels = set(channels)
    for track in score[1:]:
        kept = []
        for ev in track:
            ci = EVENT_CHANNEL_INDEX.get(ev[0])
            if ci is None or ev[ci] in channels:
                kept.append(ev)
        new_score.append(kept)
    return new_score


def score_type(opus_or_score=None) -> str:
    """Classify a structure as 'opus', 'score' or '' (MIDI.py:690-703)."""
    if opus_or_score is None or not isinstance(opus_or_score, list) or len(opus_or_score) < 2:
        return ""
    for track in opus_or_score[1:]:
        for ev in track:
            if ev[0] == "note":
                return "score"
            if ev[0] == "note_on":
                return "opus"
    return ""


def timeshift(score=None, shift=None, start_time=None, from_time=0,
              tracks={0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 13, 14, 15}) -> list:
    """Shift a score in time (MIDI.py:529-617).

    Only events at/after ``from_time`` move; set_tempo never moves right; with a
    negative shift, events inside the dropped window are deleted; shifts that
    would go negative are clamped so the earliest event lands at tick 0.
    """
    if score is None or len(score) < 2:
        return [1000, []]
    new_score: list = [score[0]]
    kind = score_type(score)
    if kind != "score":
        return new_score
    if shift is not None and start_time is not None:
        shift = None  # start_time wins, like the reference
    if shift is None and (start_time is None or start_time < 0):
        start_time = 0

    tracks = set(tracks)
    earliest = 1000000000
    if start_time is not None or (shift is not None and shift < 0):
        for i, track in enumerate(score[1:]):
            if tracks and i not in tracks:
                continue
            for ev in track:
                if ev[1] >= from_time and ev[1] < earliest:
                    earliest = ev[1]
    if earliest > 999999999:
        earliest = 0
    if shift is None:
        shift = start_time - earliest
    elif earliest + shift < 0:
        shift = -earliest

    for i, track in enumerate(score[1:]):
        if not tracks or i not in tracks:
            new_score.append(track)
            continue
        new_track = []
        for ev in track:
            new_ev = list(ev)
            if new_ev[1] >= from_time:
                if new_ev[0] != "set_tempo" or shift < 0:
                    new_ev[1] += shift
            elif shift < 0 and new_ev[1] >= from_time + shift:
                continue
            new_track.append(new_ev)
        if new_track:
            new_score.append(new_track)
    return new_score


def segment(score=None, start_time=None, end_time=None, start=0, end=100000000,
            tracks={0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15}) -> list:
    """Extract [start_time, end_time] from a score, restoring the most recent
    tempo/patch/controller state at the segment boundary (MIDI.py:620-687)."""
    if score is None or len(score) < 2:
        return [1000, []]
    if start_time is None:
        start_time = start
    if end_time is None:
        end_time = end
    new_score: list = [score[0]]
    kind = score_type(score)
    if kind != "score":
        return new_score
    tracks = set(tracks)
    for i, track in enumerate(score[1:]):
        if tracks and i not in tracks:
            continue
        new_track = []
        cc_state: dict = {}  # channel -> (time, controller, value)
        patch_state: dict = {}  # channel -> (time, patch)
        tempo_num, tempo_time = 500000, 0
        for ev in track:
            if ev[0] == "control_change":
                prev_t = cc_state.get(ev[2], (0,))[0]
                if ev[1] <= start_time and ev[1] >= prev_t:
                    cc_state[ev[2]] = (ev[1], ev[3], ev[4])
            elif ev[0] == "patch_change":
                prev_t = patch_state.get(ev[2], (0,))[0]
                if ev[1] <= start_time and ev[1] >= prev_t:
                    patch_state[ev[2]] = (ev[1], ev[3])
            elif ev[0] == "set_tempo":
                if ev[1] <= start_time and ev[1] >= tempo_time:
                    tempo_num, tempo_time = ev[2], ev[1]
            if start_time <= ev[1] <= end_time:
                new_track.append(ev)
        if new_track:
            new_track.append(["set_tempo", start_time, tempo_num])
            for c, (_, p) in patch_state.items():
                new_track.append(["patch_change", start_time, c, p])
            for c, (_, num, val) in cc_state.items():
                new_track.append(["control_change", start_time, c, num, val])
            new_score.append(new_track)
    return new_score


def _consistentise_ticks(scores: list) -> list:
    """Convert scores to a common ticks base if they differ (MIDI.py:1244)."""
    if len(scores) == 1:
        return copy.deepcopy(scores)
    ticks = scores[0][0]
    if all(s[0] == ticks for s in scores[1:]):
        return copy.deepcopy(scores)
    return [opus2score(to_millisecs(score2opus(s))) for s in scores]


def concatenate_scores(scores: list) -> list:
    """Concatenate scores end-to-end (MIDI.py:706-726)."""
    inputs = _consistentise_ticks(scores)
    output = copy.deepcopy(inputs[0])
    for score in inputs[1:]:
        delta = score2stats(output)["nticks"]
        for i, track in enumerate(score[1:], start=1):
            if i >= len(output):
                output.append([])
            for ev in track:
                shifted = copy.deepcopy(ev)
                shifted[1] += delta
                output[i].append(shifted)
    return output


def merge_scores(scores: list) -> list:
    """Merge scores side-by-side as extra tracks, remapping clashing channels
    (channel 9 stays 9, GM percussion) (MIDI.py:729-765)."""
    inputs = _consistentise_ticks(scores)
    output: list = [1000]
    used: set = set()
    all_channels = {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15}
    for score in inputs:
        new_channels = set(score2stats(score).get("channels_total", []))
        new_channels.discard(9)
        for channel in used & new_channels:
            free = sorted(all_channels - (used | new_channels))
            if not free:
                break
            target = free[0]
            for track in score[1:]:
                for ev in track:
                    ci = EVENT_CHANNEL_INDEX.get(ev[0])
                    if ci is not None and ev[ci] == channel:
                        ev[ci] = target
            used.add(target)
        used |= new_channels
        output.extend(score[1:])
    return output


def mix_scores(scores: list) -> list:
    """Mix all tracks of all scores into a single track (MIDI.py:790-802)."""
    inputs = _consistentise_ticks(scores)
    output: list = [1000, []]
    for score in inputs:
        for track in score[1:]:
            output[1].extend(track)
    return output


def mix_opus_tracks(input_tracks: list) -> list:
    """Mix several opus tracks into one opus track (MIDI.py:772-787)."""
    merged: list = [1000, []]
    for track in input_tracks:
        score = opus2score([1000, list(track)])
        merged[1].extend(score[1])
    merged[1].sort(key=lambda ev: ev[1])
    return score2opus(merged)[1]


def score2stats(opus_or_score=None) -> dict:
    """Basic statistics over a score or opus (MIDI.py:805-923)."""
    empty = {
        "bank_select": [], "channels_by_track": [], "channels_total": [],
        "general_midi_mode": [], "ntracks": 0, "nticks": 0,
        "num_notes_by_channel": {}, "patch_changes_by_track": [],
        "patch_changes_total": [], "percussion": {}, "pitches": {},
        "pitch_range_by_track": [], "ticks_per_quarter": 0,
        "pitch_range_sum": 0,
    }
    if opus_or_score is None:
        return empty

    bank_msb = bank_lsb = -1
    bank_select: list = []
    channels_by_track: list = []
    channels_total: set = set()
    general_midi_mode: list = []
    num_notes_by_channel: dict = {}
    patch_changes_by_track: list = []
    patch_changes_total: set = set()
    percussion: dict = {}
    pitches: dict = {}
    pitch_range_by_track: list = []
    pitch_range_sum = 0
    nticks = 0
    is_score = True

    for track in opus_or_score[1:]:
        hi, lo = 0, 128
        track_channels: set = set()
        track_patches: dict = {}
        for ev in track:
            if ev[0] == "note":
                num_notes_by_channel[ev[3]] = num_notes_by_channel.get(ev[3], 0) + 1
                if ev[3] == 9:
                    percussion[ev[4]] = percussion.get(ev[4], 0) + 1
                else:
                    pitches[ev[4]] = pitches.get(ev[4], 0) + 1
                    hi = max(hi, ev[4])
                    lo = min(lo, ev[4])
                track_channels.add(ev[3])
                channels_total.add(ev[3])
                nticks = max(nticks, ev[1] + ev[2])
            elif ev[0] == "note_off" or (ev[0] == "note_on" and ev[4] == 0):
                nticks = max(nticks, ev[1])
            elif ev[0] == "note_on":
                is_score = False
                num_notes_by_channel[ev[2]] = num_notes_by_channel.get(ev[2], 0) + 1
                if ev[2] == 9:
                    percussion[ev[3]] = percussion.get(ev[3], 0) + 1
                else:
                    pitches[ev[3]] = pitches.get(ev[3], 0) + 1
                    hi = max(hi, ev[3])
                    lo = min(lo, ev[3])
                track_channels.add(ev[2])
                channels_total.add(ev[2])
            elif ev[0] == "patch_change":
                track_patches[ev[2]] = ev[3]
                patch_changes_total.add(ev[3])
            elif ev[0] == "control_change":
                if ev[3] == 0:
                    bank_msb = ev[4]
                elif ev[3] == 32:
                    bank_lsb = ev[4]
                if bank_msb >= 0 and bank_lsb >= 0:
                    bank_select.append((bank_msb, bank_lsb))
                    bank_msb = bank_lsb = -1
            elif ev[0] == "sysex_f0":
                mode = SYSEX2MIDIMODE.get(ev[2], -1)
                if mode >= 0:
                    general_midi_mode.append(mode)
            if is_score:
                nticks = max(nticks, ev[1])
            else:
                nticks += ev[1]
        if lo == 128:
            lo = 0
        channels_by_track.append(track_channels)
        patch_changes_by_track.append(track_patches)
        pitch_range_by_track.append((lo, hi))
        pitch_range_sum += hi - lo

    return {
        "bank_select": bank_select,
        "channels_by_track": channels_by_track,
        "channels_total": channels_total,
        "general_midi_mode": general_midi_mode,
        "ntracks": len(opus_or_score) - 1,
        "nticks": nticks,
        "num_notes_by_channel": num_notes_by_channel,
        "patch_changes_by_track": patch_changes_by_track,
        "patch_changes_total": patch_changes_total,
        "percussion": percussion,
        "pitches": pitches,
        "pitch_range_by_track": pitch_range_by_track,
        "pitch_range_sum": pitch_range_sum,
        "ticks_per_quarter": opus_or_score[0],
    }
