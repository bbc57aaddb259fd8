"""The port's native C++ decoder and tokenizer scan (``midi_model_tpu_torch.native``)
against its Python paths on the golden corpus, mirroring
``tests/test_native_codec.py`` and ``tests/test_tokenizer.py``'s scan parity.
The extensions build in a module fixture (g++ at first use), never at import."""

import pickle
import shutil
import struct
from pathlib import Path

import pytest

from midi_model_tpu_torch import native as native_pkg
from midi_model_tpu_torch.midi import codec
from midi_model_tpu_torch.native import build as native_build
from midi_model_tpu_torch.tokenizer import MIDITokenizer
from midi_model_tpu_torch.tokenizer import base as torch_base

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "golden" / "codec.pkl"
CONFIGS = ["v1_raw", "v1_opt", "v2_raw", "v2_opt"]


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native extensions cannot build")
    codec_mod = native_pkg.native_codec()
    scan_mod = native_pkg.native_tokenizer_scan()
    assert codec_mod is not None and scan_mod is not None, "g++ is there but the build failed"
    return codec_mod, scan_mod


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDEN, "rb") as f:
        return pickle.load(f)


def test_sources_are_copies_and_build_out_of_tree():
    """Each source is the JAX package's with only the module paths in its
    comments renamed, and builds under build/ keyed by its hash."""
    for name in native_build.MODULES:
        ours = (native_build.HERE / f"{name}.cpp").read_text()
        theirs = (ROOT / "midi_model_tpu" / "native" / f"{name}.cpp").read_text()
        assert ours == theirs.replace("midi_model_tpu/", "midi_model_tpu_torch/"), name
        lib = native_build.library_path(name)
        assert lib.parent == ROOT / "build" / "midi_model_tpu_torch" / "native"
        cmd = native_build.gxx_command(name, lib)
        assert cmd[:5] == ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]
        assert "torch" not in " ".join(cmd[5:-3])


def test_midi2opus_matches_python(native, goldens):
    mod = native[0]
    for name, g in goldens.items():
        assert mod.midi2opus(g["bytes"]) == codec._py_midi2opus(g["bytes"]) == g["opus"], name


def test_midi2score_matches_python(native, goldens):
    mod = native[0]
    for name, g in goldens.items():
        assert mod.midi2score(g["bytes"]) == g["score"], name
        assert codec.midi2score(g["bytes"]) == g["score"], name  # the dispatch


def test_opus2score_matches_python(native, goldens):
    mod = native[0]
    for name, g in goldens.items():
        if name.startswith("bad_"):
            continue
        assert mod.opus2score(g["opus"]) == codec._py_opus2score(g["opus"]), name


def test_malformed(native):
    mod = native[0]
    assert mod.midi2opus(b"") == [1000, []]
    assert mod.midi2opus(b"MT") == [1000, []]
    assert mod.midi2score(b"\x00" * 64) == [1000, []]


def _mk(body):
    return (b"MThd" + struct.pack(">IHHH", 6, 1, 1, 480)
            + b"MTrk" + struct.pack(">I", len(body)) + body)


HUGE = bytes([0xFF] * 9 + [0x7F])  # a varint with 9 continuation bytes
HOSTILE = [
    b"\x00\xFF\x01" + HUGE + b"AB",      # meta length >> payload
    b"\x00\xF0" + HUGE + b"ZZ",          # sysex length >> payload
    b"\x00\xFF\x01" + bytes([0xFF] * 5),  # varint truncated mid-stream
    b"\x00\xFF\x51" + HUGE,               # huge length, empty body
    b"\x00\x90\x40",                      # truncated channel event
    b"\x00\xF2\x01",                      # truncated song_position
    b"\x00\xF4",                          # lone unknown F-series lead
]


@pytest.mark.parametrize("body", HOSTILE, ids=range(len(HOSTILE)))
def test_hostile_varints_parity(native, body):
    """Oversized or truncated varints neither crash nor differ from the
    Python path, which clamps reads to the track payload."""
    data = _mk(body)
    assert native[0].midi2opus(data) == codec._py_midi2opus(data), body


def test_hostile_varint_keeps_track_framing(native):
    """The huge meta length clamps the cursor to the end of track 1 and
    leaves track 2's chunk framing intact."""
    two = (b"MThd" + struct.pack(">IHHH", 6, 1, 2, 480)
           + b"MTrk" + struct.pack(">I", 15)
           + b"\x00\xFF\x01" + HUGE + b"AB"
           + b"MTrk" + struct.pack(">I", 4) + b"\x00\xFF\x2F\x00")
    expect = [480, [["text_event", 0, b"AB"]], []]
    assert native[0].midi2opus(two) == expect
    assert codec._py_midi2opus(two) == expect


@pytest.mark.parametrize("key", CONFIGS)
def test_python_scan_matches_native(native, goldens, key, monkeypatch):
    """Both scan-phase implementations tokenize identically."""
    assert torch_base._native_scan() is native[1]
    version, mode = key.split("_")
    tok = MIDITokenizer(version)
    tok.set_optimise_midi(mode == "opt")
    scores = {k: g["score"] for k, g in goldens.items() if not k.startswith("bad_")}
    native_out = {name: tok.tokenize(score) for name, score in scores.items()}
    monkeypatch.setattr(torch_base, "_native_scan", lambda: None)
    for name, score in scores.items():
        assert tok.tokenize(score) == native_out[name], f"{key}/{name}"


def test_disabled_by_environment(native, monkeypatch):
    """MIDI_TPU_NATIVE=0 turns both extensions off: the Python paths run."""
    monkeypatch.setenv("MIDI_TPU_NATIVE", "0")
    assert native_pkg.native_codec() is None and native_pkg.native_tokenizer_scan() is None
    assert codec._native_codec() is None and torch_base._native_scan() is None
    monkeypatch.delenv("MIDI_TPU_NATIVE")
    assert native_pkg.native_codec() is native[0]


def test_failed_build_takes_the_python_path(monkeypatch, tmp_path):
    """Without g++ (or with a failing build) the loaders return None and
    nothing is left behind in the build directory."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "gxx_command",
                        lambda name, out: ["g++-that-does-not-exist", str(out)])
    monkeypatch.setattr(native_pkg, "_modules", {})
    assert native_pkg.native_codec() is None
    assert native_pkg._modules == {"midicodec": None}  # not retried on every call
    monkeypatch.setattr(native_build, "gxx_command",
                        lambda name, out: ["false", str(out)])
    monkeypatch.setattr(native_pkg, "_modules", {})
    assert native_pkg.native_tokenizer_scan() is None
    assert not list(tmp_path.iterdir())


def test_build_once_moves_a_whole_file_into_place(tmp_path):
    """The build step both compiled parts share: compile to a temporary
    name, move it into place, and build an existing output never again."""
    from midi_model_tpu_torch.utils.build import build_once

    calls = []

    def compile_to(tmp):
        calls.append(tmp)
        tmp.write_bytes(b"library")

    out = tmp_path / "sub" / "lib.so"
    assert build_once(out, compile_to) == out and out.read_bytes() == b"library"
    assert build_once(out, compile_to) == out and len(calls) == 1
    assert calls[0] != out and [p.name for p in out.parent.iterdir()] == ["lib.so"]
