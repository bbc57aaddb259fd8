"""FluidSynth audio rendering pool (host-side; audio is not a device workload).

The port's copy of ``midi_model_tpu/serve/synth.py`` (numpy only; held
equal to it by ``tests/test_torch_app.py``).  Behavior parity with the
reference synthesizer (its midi_synthesizer.py): a lock-guarded pool of
reusable synth instances, tempo-aware sample stepping over a time-sorted
flattened opus, and int16 peak normalization.  The ``fluidsynth`` binding
is optional — importing this module without it installed still works; only
synthesis raises.
"""

from __future__ import annotations

from threading import Lock
from typing import List, Optional

import numpy as np


class MidiSynthesizer:
    def __init__(self, soundfont_path: str, sample_rate: int = 44100):
        import fluidsynth  # optional native dependency

        self._fluidsynth = fluidsynth
        self.soundfont_path = soundfont_path
        self.sample_rate = sample_rate
        self._pool: List[list] = [self._new_device()]
        self._lock = Lock()

    def _new_device(self) -> list:
        synth = self._fluidsynth.Synth(samplerate=float(self.sample_rate))
        sfid = synth.sfload(self.soundfont_path)
        return [synth, sfid, False]

    def _acquire(self) -> list:
        with self._lock:
            for device in self._pool:
                if not device[2]:
                    device[2] = True
                    return device
            device = self._new_device()
            device[2] = True
            self._pool.append(device)
            return device

    def _release(self, device: list):
        device[0].system_reset()
        device[0].get_samples(self.sample_rate * 5)  # drain to silence
        device[2] = False

    def synthesis(self, midi_opus: list) -> np.ndarray:
        """Render an opus to int16 stereo samples at the pool's sample rate."""
        ticks_per_beat = midi_opus[0]
        events = []
        for track in midi_opus[1:]:
            now = 0
            for ev in track:
                now += ev[1]
                events.append([ev[0], now] + list(ev[2:]))
        events.sort(key=lambda e: e[1])

        tempo = 500000  # 120 bpm default
        chunks: List[np.ndarray] = []
        device = self._acquire()
        try:
            synth, sfid = device[0], device[1]
            for c in range(16):
                synth.program_select(c, sfid, 128 if c == 9 else 0, 0)
            last_t = 0
            for ev in events:
                name = ev[0]
                n = int((ev[1] / ticks_per_beat) * tempo / 1e6 * self.sample_rate)
                n -= int((last_t / ticks_per_beat) * tempo / 1e6 * self.sample_rate)
                last_t = ev[1]
                if n > 0:
                    chunks.append(synth.get_samples(n).reshape(n, 2))
                if name == "set_tempo":
                    tempo = ev[2]
                elif name == "patch_change":
                    c, p = ev[2], ev[3]
                    synth.program_select(c, sfid, 128 if c == 9 else 0, p)
                elif name == "control_change":
                    synth.cc(ev[2], ev[3], ev[4])
                elif name == "note_on" and ev[4] > 0:
                    synth.noteon(ev[2], ev[3], ev[4])
                elif name == "note_off" or (name == "note_on" and ev[4] == 0):
                    synth.noteoff(ev[2], ev[3])
        finally:
            self._release(device)

        if not chunks:
            return np.empty((0, 2), dtype=np.int16)
        samples = np.concatenate(chunks).astype(np.float64)
        peak = np.abs(samples).max()
        if peak != 0:
            samples = samples / peak * np.iinfo(np.int16).max
        return samples.astype(np.int16)


def load_synthesizer(soundfont_path: Optional[str]) -> Optional[MidiSynthesizer]:
    """Best-effort constructor: returns None when fluidsynth/sf2 is missing."""
    if not soundfont_path:
        return None
    try:
        return MidiSynthesizer(soundfont_path)
    except Exception:
        return None
