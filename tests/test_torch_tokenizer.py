"""The port's own tokenizer (``midi_model_tpu_torch.tokenizer``) against the
JAX package's and the reference goldens (``tests/golden/tokenizer.pkl``),
mirroring ``tests/test_tokenizer.py``: vocab layout, tokenize, detokenize
and the second pass identical, ``to_dict`` equal, and both of the port's
scans (Python, and native where it builds) equal to the JAX package's
tokenizer, whichever scan that one runs."""

import pickle
import random
import shutil
from pathlib import Path

import numpy as np
import pytest

from midi_model_tpu.tokenizer import MIDITokenizer as JaxTokenizer
from midi_model_tpu_torch.tokenizer import MIDITokenizer
from midi_model_tpu_torch.tokenizer import base as torch_base

GOLDEN = Path(__file__).parent / "golden" / "tokenizer.pkl"
CODEC_GOLDEN = Path(__file__).parent / "golden" / "codec.pkl"

CONFIGS = ["v1_raw", "v1_opt", "v2_raw", "v2_opt"]


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDEN, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def scores():
    with open(CODEC_GOLDEN, "rb") as f:
        return {k: v["score"] for k, v in pickle.load(f).items()
                if not k.startswith("bad_")}


def make_tok(key, factory=MIDITokenizer):
    version, mode = key.split("_")
    tok = factory(version)
    tok.set_optimise_midi(mode == "opt")
    return tok


def _files(g):
    return [(name, rec) for name, rec in g["files"].items() if "error" not in rec]


@pytest.mark.parametrize("key", CONFIGS)
def test_vocab_layout_matches_golden_and_jax(goldens, key):
    g = goldens[key]
    tok, jtok = make_tok(key), make_tok(key, JaxTokenizer)
    assert tok.vocab_size == g["vocab_size"] == jtok.vocab_size
    assert tok.max_token_seq == g["max_token_seq"]
    assert tok.events == g["events"]
    assert tok.event_parameters == g["event_parameters"]
    assert tok.event_ids == g["event_ids"] == jtok.event_ids
    assert tok.parameter_ids == g["parameter_ids"]
    assert tok.to_dict() == g["to_dict"] == jtok.to_dict()


@pytest.mark.parametrize("key", CONFIGS)
def test_tokenize_and_detokenize_match_golden(goldens, scores, key):
    tok = make_tok(key)
    for name, rec in _files(goldens[key]):
        assert tok.tokenize(scores[name]) == rec["tokens"], f"{key}/{name}"
        assert tok.detokenize(rec["tokens"]) == rec["detok"], f"{key}/{name}"
        assert tok.tokenize(rec["detok"]) == rec["tokens2"], f"{key}/{name}"
        assert tuple(tok.check_quality(rec["tokens"])) == tuple(rec["quality"])


@pytest.mark.parametrize("key", CONFIGS)
def test_python_scan_matches_jax_tokenizer(scores, key, monkeypatch):
    """The port's Python scan (the native one patched away) gives the JAX
    package's tokenizer's rows (native scan when built)."""
    monkeypatch.setattr(torch_base, "_native_scan", lambda: None)
    tok, jtok = make_tok(key), make_tok(key, JaxTokenizer)
    for name, score in scores.items():
        assert tok.tokenize(score) == jtok.tokenize(score), f"{key}/{name}"


@pytest.mark.parametrize("key", CONFIGS)
def test_native_scan_matches_jax_tokenizer(scores, key):
    """The port's native scan (``native/tokenizer_scan.cpp``, built at first
    use) gives the JAX package's tokenizer's rows too."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native scan cannot build")
    assert torch_base._native_scan() is not None
    tok, jtok = make_tok(key), make_tok(key, JaxTokenizer)
    for name, score in scores.items():
        assert tok.tokenize(score) == jtok.tokenize(score), f"{key}/{name}"


def test_augment_matches_golden(goldens, scores):
    """Seeded augmentation consumes the RNG as the reference does."""
    tok = MIDITokenizer("v2")
    for name, expected in goldens["v2_augment_seed1234"].items():
        seq = tok.tokenize(scores[name])
        random.seed(1234)
        assert tok.augment(seq) == expected, name


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_event_roundtrip_and_grammar_tables(version):
    tok, jtok = MIDITokenizer(version), JaxTokenizer(version)
    for name, params in tok.events.items():
        event = [name] + [min(3, tok.event_parameters[p] - 1) for p in params]
        tokens = tok.event2tokens(event)
        assert tokens == jtok.event2tokens(event)
        assert tok.tokens2event(tokens) == event
    assert tok.event2tokens(["set_tempo", 0, 0, 0, 10**6]) == []
    ours, theirs = tok.vocab.grammar_tables(), jtok.vocab.grammar_tables()
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)
