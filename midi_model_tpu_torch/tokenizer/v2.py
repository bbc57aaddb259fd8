"""Tokenizer v2: adds time/key signatures, vocab 3406, bpm capped at 383.

Schema parity: the reference's midi_tokenizer.py:506-535.  Note parameters are
ordered [..., channel, pitch, velocity, duration] (different from v1!).
"""

from .base import EventTokenizerBase


class MIDITokenizerV2(EventTokenizerBase):
    version = "v2"
    EVENTS = {
        "note": ["time1", "time2", "track", "channel", "pitch", "velocity", "duration"],
        "patch_change": ["time1", "time2", "track", "channel", "patch"],
        "control_change": ["time1", "time2", "track", "channel", "controller", "value"],
        "set_tempo": ["time1", "time2", "track", "bpm"],
        "time_signature": ["time1", "time2", "track", "nn", "dd"],
        "key_signature": ["time1", "time2", "track", "sf", "mi"],
    }
    EVENT_PARAMETERS = {
        "time1": 128, "time2": 16, "duration": 2048, "track": 128, "channel": 16,
        "pitch": 128, "velocity": 128, "patch": 128, "controller": 128,
        "value": 128, "bpm": 384, "nn": 16, "dd": 4, "sf": 15, "mi": 2,
    }
    BPM_MAX = 383
    HAS_SIGNATURES = True
    EVENT_SORT_ORDER = ["time_signature", "key_signature", "set_tempo",
                        "patch_change", "control_change", "note"]
    SETUP_KEEP_TIME = ("note", "time_signature")
