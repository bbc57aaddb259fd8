"""Tokenizer v1: 4 event kinds, vocab 3239, bpm capped at 255.

Schema parity: the reference's midi_tokenizer.py:8-35.  Note parameters are
ordered [..., duration, channel, pitch, velocity].
"""

from .base import EventTokenizerBase


class MIDITokenizerV1(EventTokenizerBase):
    version = "v1"
    EVENTS = {
        "note": ["time1", "time2", "track", "duration", "channel", "pitch", "velocity"],
        "patch_change": ["time1", "time2", "track", "channel", "patch"],
        "control_change": ["time1", "time2", "track", "channel", "controller", "value"],
        "set_tempo": ["time1", "time2", "track", "bpm"],
    }
    EVENT_PARAMETERS = {
        "time1": 128, "time2": 16, "duration": 2048, "track": 128, "channel": 16,
        "pitch": 128, "velocity": 128, "patch": 128, "controller": 128,
        "value": 128, "bpm": 256,
    }
    BPM_MAX = 255
    HAS_SIGNATURES = False
    EVENT_SORT_ORDER = ["set_tempo", "patch_change", "control_change", "note"]
    SETUP_KEEP_TIME = ("note",)
