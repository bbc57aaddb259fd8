"""Standard MIDI File codec: ``bytes`` ⇄ ``opus`` ⇄ ``score``.

The port's own copy of ``midi_model_tpu/midi/codec.py``; decoding
dispatches to the port's native C++ decoder (``midi_model_tpu_torch.native``)
where it builds, and runs the Python path below otherwise.

Event model (kept list-based for drop-in familiarity with the reference API,
see the reference's MIDI.py:41-77 for the event catalogue):

- An **opus** is ``[ticks_per_quarter, track0, track1, ...]`` where each track is a
  list of events carrying *delta* times in ticks:
  ``['note_on', dtime, channel, pitch, velocity]`` etc.
- A **score** is the same structure with *absolute* times, and with note_on/note_off
  pairs fused into ``['note', start, duration, channel, pitch, velocity]``.

Behavior parity notes (validated by golden tests against the reference
implementation, the reference's MIDI.py v6.7):

- running status decode (MIDI.py:1308-1314) and encode (MIDI.py:1660).
- BER variable-length ints (MIDI.py:1165-1202).
- ``note_on`` with velocity 0 closes a note like ``note_off`` (MIDI.py:362).
- unterminated notes are closed at end-of-track (MIDI.py:386-392).
- end-of-track meta with a positive delta becomes a null ``text_event`` carrying
  the delta (MIDI.py:1537-1544); a trailing zero-length text_event is turned back
  into ``end_track`` on encode (MIDI.py:1581-1597).
- malformed input returns the partially decoded structure instead of raising.

Unlike the reference (which repeatedly slices bytearrays, O(n^2) over a track),
this implementation walks a memoryview with an explicit cursor, so decoding is
linear and several times faster — it is the hot host-side path feeding the
training data pipeline.
"""

from __future__ import annotations

import struct
from typing import List, Optional

__all__ = [
    "midi2opus",
    "opus2score",
    "midi2score",
    "score2opus",
    "opus2midi",
    "score2midi",
    "midi2ms_score",
]


def _native_codec():
    """The optional C++ decoder (``native/midicodec.cpp``), or None."""
    from ..native import native_codec

    return native_codec()

# Meta-event command byte -> event name for fixed-layout metas handled specially.
_TEXT_META_NAMES = {
    0x01: "text_event",
    0x02: "copyright_text_event",
    0x03: "track_name",
    0x04: "instrument_name",
    0x05: "lyric",
    0x06: "marker",
    0x07: "cue_point",
    0x08: "text_event_08",
    0x09: "text_event_09",
    0x0A: "text_event_0a",
    0x0B: "text_event_0b",
    0x0C: "text_event_0c",
    0x0D: "text_event_0d",
    0x0E: "text_event_0e",
    0x0F: "text_event_0f",
}
_TEXT_META_CODES = {name: code for code, name in _TEXT_META_NAMES.items()}

# Channel-voice events: status high nibble -> (name, n_param_bytes)
_CHANNEL_EVENTS = {
    0x80: ("note_off", 2),
    0x90: ("note_on", 2),
    0xA0: ("key_after_touch", 2),
    0xB0: ("control_change", 2),
    0xC0: ("patch_change", 1),
    0xD0: ("channel_after_touch", 1),
    0xE0: ("pitch_wheel_change", 2),
}


class _TrackReader:
    """Cursor over one MTrk payload."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.end = len(data)

    def remaining(self) -> int:
        return self.end - self.pos

    def u8(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        # Clamp to the payload so an oversized declared length (malformed
        # or malicious varint) truncates instead of pushing the cursor past
        # ``end`` (a negative ``remaining()`` is truthy and corrupts the
        # decode loop). Matches the native decoder and the reference's
        # bytes-slicing behavior (the reference's MIDI.py:1268+).
        n = min(n, self.end - self.pos)
        chunk = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        return chunk

    def varint(self) -> int:
        """Big-endian base-128 varint; tolerates truncation (yields 0)."""
        if self.pos >= self.end:
            return 0
        value = 0
        while True:
            byte = self.data[self.pos]
            self.pos += 1
            value += byte & 0x7F
            if not byte & 0x80:
                return value
            if self.pos >= self.end:
                return 0
            value <<= 7


def _decode_track(payload: bytes) -> list:
    """Decode one MTrk payload into a list of delta-time opus events."""
    r = _TrackReader(payload)
    events: list = []
    status = -1  # running-status register

    while r.remaining():
        dtime = r.varint()
        if not r.remaining():
            break
        lead = r.u8()

        if lead < 0xF0:
            # Channel-voice message, possibly via running status.
            if lead & 0x80:
                status = lead
            else:
                r.pos -= 1  # data byte: reuse previous status
                if status == -1:
                    # No status to run with: the whole track is unusable.
                    return []
            name, nparams = _CHANNEL_EVENTS[status & 0xF0]
            channel = status & 0x0F
            # Truncated channel event: stop gracefully (the reference raises
            # IndexError here and relies on callers to catch; we return the
            # partial track instead, matching the native decoder).
            if r.remaining() < nparams:
                break
            if nparams == 1:
                p0 = r.u8()
                events.append([name, dtime, channel, p0])
            else:
                p0 = r.u8()
                p1 = r.u8()
                if name == "pitch_wheel_change":
                    events.append([name, dtime, channel, (p0 | (p1 << 7)) - 0x2000])
                else:
                    events.append([name, dtime, channel, p0, p1])

        elif lead == 0xFF:
            # Meta event.
            if not r.remaining():
                break
            meta = r.u8()
            length = r.varint()
            body_start = r.pos
            if meta == 0x2F:  # end of track
                if dtime > 0:
                    # Preserve the trailing delta as a null text event.
                    events.append(["text_event", dtime, ""])
                break
            ev = _decode_meta(meta, length, dtime, r)
            if ev is not None:
                events.append(ev)
            r.pos = min(body_start + length, r.end)

        elif lead in (0xF0, 0xF7):
            length = r.varint()
            raw = r.take(length)
            events.append(["sysex_f0" if lead == 0xF0 else "sysex_f7", dtime, raw])

        elif lead == 0xF2:
            if r.remaining() < 2:
                break
            lo = r.u8()
            hi = r.u8()
            events.append(["song_position", dtime, lo | (hi << 7)])
        elif lead == 0xF3:
            if r.remaining() < 1:
                break
            events.append(["song_select", dtime, r.u8()])
        elif lead == 0xF6:
            events.append(["tune_request", dtime])
        elif lead > 0xF0:
            # Unknown F-series event: swallow one byte as raw data.
            if r.remaining() < 1:
                break
            events.append(["raw_data", dtime, r.u8()])
        else:  # pragma: no cover — unreachable (lead >= 0xF0 handled above)
            break
    return events


def _decode_meta(meta: int, length: int, dtime: int, r: _TrackReader) -> Optional[list]:
    """Decode a (non end-of-track) meta event body starting at r.pos."""
    body = bytes(r.data[r.pos : min(r.pos + length, r.end)])
    if meta == 0x00:
        if length == 2 and len(body) == 2:
            return ["set_sequence_number", dtime, (body[0] << 8) | body[1]]
        return ["set_sequence_number", dtime, 0]
    if 0x01 <= meta <= 0x0F:
        return [_TEXT_META_NAMES[meta], dtime, body]
    if meta == 0x51:
        return ["set_tempo", dtime, int.from_bytes(body[:3].rjust(3, b"\x00"), "big")]
    if meta == 0x54:
        vals = list(body[:5]) + [0] * max(0, 5 - len(body))
        return ["smpte_offset", dtime] + vals[:5]
    if meta == 0x58:
        return ["time_signature", dtime] + list(body[:4])
    if meta == 0x59:
        if len(body) >= 2:
            sf = body[0] - 256 if body[0] > 127 else body[0]  # signed
            return ["key_signature", dtime, sf, body[1]]
        return ["key_signature", dtime, 0, 0]
    if meta == 0x7F:
        return ["sequencer_specific", dtime, body]
    return ["raw_meta_event", dtime, meta, body]


def midi2opus(midi: bytes = b"") -> list:
    """Decode Standard MIDI File bytes into an opus (delta-time event lists).

    Parity: reference midi2opus (the reference's MIDI.py:304-343), including its
    graceful handling of malformed headers/tracks (returns partial results).

    Dispatches to the native C++ decoder when it builds
    (midi_model_tpu_torch.native); the python path below is the
    always-available reference implementation.
    """
    native = _native_codec()
    if native is not None:
        return native.midi2opus(bytes(midi))
    return _py_midi2opus(midi)


def _py_midi2opus(midi: bytes = b"") -> list:
    data = bytes(midi)
    if len(data) < 14 or data[:4] != b"MThd":
        return [1000, []]
    length, _fmt, _ntracks, ticks = struct.unpack(">IHHH", data[4:14])
    if length != 6:
        return [1000, []]
    opus: list = [ticks]
    pos = 14
    while len(data) - pos >= 8:
        # Chunk type is not enforced (some files carry stray chunk ids).
        (track_len,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        pos += 8
        if track_len > len(data) - pos:
            return opus  # truncated file: return what we have
        opus.append(_decode_track(data[pos : pos + track_len]))
        pos += track_len
    return opus


def opus2score(opus: Optional[list] = None) -> list:
    """Fuse note_on/note_off pairs into ['note', start, dur, ch, pitch, vel].

    Parity: reference opus2score (the reference's MIDI.py:346-395):
    - FIFO matching per (channel, pitch);
    - ``note_on`` velocity 0 acts as note-off;
    - a fused note is emitted at the position of its note_off in the stream;
    - unterminated notes are closed at the final track time and appended last.
    """
    native = _native_codec()
    if native is not None and isinstance(opus, list) and len(opus) >= 2:
        return native.opus2score(opus)
    return _py_opus2score(opus)


def _py_opus2score(opus: Optional[list] = None) -> list:
    if opus is None or len(opus) < 2:
        return [1000, []]
    score: list = [int(opus[0])]
    for track in opus[1:]:
        now = 0
        out: list = []
        open_notes: dict = {}  # (channel<<7 | pitch) -> FIFO of pending note events
        for ev in track:
            now += ev[1]
            name = ev[0]
            if name == "note_off" or (name == "note_on" and ev[4] == 0):
                key = ev[2] * 128 + ev[3]
                fifo = open_notes.get(key)
                if fifo:
                    note = fifo.pop(0)
                    note[2] = now - note[1]
                    out.append(note)
            elif name == "note_on":
                key = ev[2] * 128 + ev[3]
                note = ["note", now, 0, ev[2], ev[3], ev[4]]
                open_notes.setdefault(key, []).append(note)
            else:
                out.append([name, now] + list(ev[2:]))
        for fifo in open_notes.values():
            for note in fifo:
                note[2] = now - note[1]
                out.append(note)
        score.append(out)
    return score


def midi2score(midi: bytes = b"") -> list:
    """MIDI bytes -> score. Parity: reference midi2score (MIDI.py:398)."""
    native = _native_codec()
    if native is not None:
        return native.midi2score(bytes(midi))
    return _py_opus2score(_py_midi2opus(midi))


def score2opus(score: Optional[list] = None) -> list:
    """Split notes back into note_on/note_off and convert to delta times.

    Parity: reference score2opus (the reference's MIDI.py:225-292). Events that
    share a timestamp keep their original relative order (stable bucket sort by
    absolute time); each note contributes a note_on at start and a note_off
    (same velocity) at start+duration.
    """
    if score is None or len(score) < 2:
        return [1000, []]
    opus: list = [int(score[0])]
    for track in score[1:]:
        buckets: dict = {}  # abs_time -> [event, ...] in insertion order
        for ev in track:
            if ev[0] == "note":
                start, dur, ch, pitch, vel = ev[1], ev[2], ev[3], ev[4], ev[5]
                buckets.setdefault(start, []).append(["note_on", start, ch, pitch, vel])
                buckets.setdefault(start + dur, []).append(
                    ["note_off", start + dur, ch, pitch, vel]
                )
            else:
                buckets.setdefault(ev[1], []).append([ev[0], ev[1]] + list(ev[2:]))
        out: list = []
        prev = 0
        for t in sorted(buckets):
            for ev in buckets[t]:
                ev[1] = t - prev
                prev = t
                out.append(ev)
        opus.append(out)
    return opus


def _varint_bytes(value: int) -> bytes:
    """Big-endian base-128 varint with continuation bits."""
    out = bytearray([value & 0x7F])
    value >>= 7
    while value > 0:
        out.insert(0, 0x80 | (value & 0x7F))
        value >>= 7
    return bytes(out)


def _text_meta_bytes(meta: int, text) -> bytes:
    if isinstance(text, str):
        data = text.encode("ISO-8859-1")
    else:
        data = bytes(text)
    return b"\xFF" + bytes((meta,)) + _varint_bytes(len(data)) + data


def _encode_track(track: list) -> bytes:
    """Encode one track's delta-time events into MTrk payload bytes.

    Parity: reference _encode (the reference's MIDI.py:1561-1772), including
    running-status compression and the end-of-track magic.
    """
    events = [list(ev) for ev in track]

    # Ensure the track ends with end_track; a trailing zero-length text_event
    # is repurposed as the end_track carrier (preserving its delta time).
    if events:
        last = events[-1]
        if last[0] != "end_track":
            if last[0] == "text_event" and len(last[2]) == 0:
                last[0] = "end_track"
            else:
                events.append(["end_track", 0])
    else:
        events = [["end_track", 0]]

    chunks: List[bytes] = []
    running = -1
    for ev in events:
        if not ev:
            continue
        name = ev[0]
        if not name:
            continue
        dtime = int(ev[1])

        if name in ("note_on", "note_off", "key_after_touch", "control_change",
                    "patch_change", "channel_after_touch", "pitch_wheel_change"):
            ch = int(ev[2]) & 0x0F
            if name == "note_off":
                status = 0x80 | ch
                params = bytes(((int(ev[3]) & 0x7F), (int(ev[4]) & 0x7F)))
            elif name == "note_on":
                status = 0x90 | ch
                params = bytes(((int(ev[3]) & 0x7F), (int(ev[4]) & 0x7F)))
            elif name == "key_after_touch":
                status = 0xA0 | ch
                params = bytes(((int(ev[3]) & 0x7F), (int(ev[4]) & 0x7F)))
            elif name == "control_change":
                status = 0xB0 | ch
                params = bytes(((int(ev[3]) & 0xFF), (int(ev[4]) & 0xFF)))
            elif name == "patch_change":
                status = 0xC0 | ch
                params = bytes((int(ev[3]) & 0xFF,))
            elif name == "channel_after_touch":
                status = 0xD0 | ch
                params = bytes((int(ev[3]) & 0xFF,))
            else:  # pitch_wheel_change
                status = 0xE0 | ch
                v = int(ev[3]) + 0x2000
                params = bytes((v & 0x7F, (v >> 7) & 0x7F))
            chunks.append(_varint_bytes(dtime))
            if status != running:
                chunks.append(bytes((status,)))
            chunks.append(params)
            running = status
            continue

        running = -1  # any non-channel event breaks running status
        body = _encode_other(name, ev)
        if body:
            chunks.append(_varint_bytes(dtime) + body)
    return b"".join(chunks)


def _encode_other(name: str, ev: list) -> bytes:
    """Encode meta/system events (no running status). Empty bytes = skip."""
    if name in _TEXT_META_CODES:
        return _text_meta_bytes(_TEXT_META_CODES[name], ev[2])
    if name == "raw_meta_event":
        return _text_meta_bytes(int(ev[2]), ev[3])
    if name == "set_sequence_number":
        return b"\xFF\x00\x02" + struct.pack(">H", int(ev[2]) & 0xFFFF)
    if name == "end_track":
        return b"\xFF\x2F\x00"
    if name == "set_tempo":
        return b"\xFF\x51\x03" + struct.pack(">I", int(ev[2]))[1:]
    if name == "smpte_offset":
        return struct.pack(">BBBbBBBB", 0xFF, 0x54, 0x05, ev[2], ev[3], ev[4], ev[5], ev[6])
    if name == "time_signature":
        return struct.pack(">BBBbBBB", 0xFF, 0x58, 0x04, ev[2], ev[3], ev[4], ev[5])
    if name == "key_signature":
        return struct.pack(">BBBbB", 0xFF, 0x59, 0x02, ev[2], ev[3])
    if name == "sequencer_specific":
        return _text_meta_bytes(0x7F, ev[2])
    if name == "sysex_f0":
        return b"\xF0" + _varint_bytes(len(ev[2])) + bytes(ev[2])
    if name == "sysex_f7":
        return b"\xF7" + _varint_bytes(len(ev[2])) + bytes(ev[2])
    if name == "song_position":
        v = int(ev[2])
        return b"\xF2" + bytes((v & 0x7F, (v >> 7) & 0x7F))
    if name == "song_select":
        return struct.pack(">BB", 0xF3, int(ev[2]))
    if name == "tune_request":
        return b"\xF6"
    return b""  # raw_data and unknown events are dropped, like the reference


def opus2midi(opus: Optional[list] = None) -> bytes:
    """Encode an opus into Standard MIDI File bytes.

    Parity: reference opus2midi (the reference's MIDI.py:186-222); format 0 for a
    single track, format 1 otherwise.
    """
    if opus is None or len(opus) < 2:
        opus = [1000, []]
    ticks = int(opus[0])
    tracks = opus[1:]
    fmt = 0 if len(tracks) == 1 else 1
    out = bytearray(b"MThd\x00\x00\x00\x06")
    out += struct.pack(">HHH", fmt, len(tracks), ticks)
    for track in tracks:
        payload = _encode_track(track)
        out += b"MTrk" + struct.pack(">I", len(payload)) + payload
    return bytes(out)


def score2midi(score: Optional[list] = None) -> bytes:
    """Score -> MIDI bytes. Parity: reference score2midi (MIDI.py:295)."""
    return opus2midi(score2opus(score))


def midi2ms_score(midi: bytes = b"") -> list:
    """MIDI bytes -> score recalibrated to 1 tick == 1 ms (MIDI.py:405-411)."""
    from .utils import to_millisecs

    return opus2score(to_millisecs(midi2opus(midi)))
