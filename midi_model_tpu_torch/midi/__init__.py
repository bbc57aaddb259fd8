"""MIDI byte codec and score utilities (host-side, pure Python).

The port's own copy of ``midi_model_tpu/midi``: the training data pipeline
(``train.data``) reads MIDI files through it."""

from .codec import (
    midi2opus,
    midi2score,
    midi2ms_score,
    opus2midi,
    opus2score,
    score2midi,
    score2opus,
)
from .constants import (
    EVENT_CHANNEL_INDEX,
    Event2channelindex,
    GM_PATCH_NAMES,
    GM_PERCUSSION_NAMES,
    Notenum2percussion,
    Number2patch,
)
from .utils import (
    concatenate_scores,
    play_score,
    grep,
    merge_scores,
    mix_opus_tracks,
    mix_scores,
    score2stats,
    score_type,
    segment,
    timeshift,
    to_millisecs,
)

__all__ = [
    "midi2opus", "midi2score", "midi2ms_score", "opus2midi", "opus2score",
    "score2midi", "score2opus", "EVENT_CHANNEL_INDEX", "Event2channelindex",
    "GM_PATCH_NAMES", "GM_PERCUSSION_NAMES", "Notenum2percussion",
    "Number2patch", "concatenate_scores", "grep", "merge_scores",
    "mix_opus_tracks", "mix_scores", "play_score", "score2stats", "score_type", "segment",
    "timeshift", "to_millisecs",
]
