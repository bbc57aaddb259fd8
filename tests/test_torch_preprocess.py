"""The port's trace exporter and corpus preprocessing against the JAX
package's, mirroring the profiling and preprocessing cases of
``tests/test_utils_misc.py``: ``process_file`` gives the JAX verdict on
every golden blob and on the size and parse rejects, and ``main`` writes
the same ``processed/`` and ``bad/<reason>/`` trees."""

import pickle
from pathlib import Path

import pytest

from midi_model_tpu.train import preprocess as jax_preprocess
from midi_model_tpu_torch.train import preprocess
from midi_model_tpu_torch.utils import trace

GOLDEN = Path(__file__).parent / "golden" / "codec.pkl"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Every golden blob as a file, plus a too-large and an unparsable one."""
    with open(GOLDEN, "rb") as f:
        goldens = pickle.load(f)
    d = tmp_path_factory.mktemp("pre_corpus")
    for name, g in goldens.items():
        (d / f"{name}.mid").write_bytes(g["bytes"])
    (d / "huge.mid").write_bytes(b"MThd" + b"\x00" * (preprocess.MAX_SIZE + 1))
    (d / "garbage.mid").write_bytes(b"x" * 5000)
    return d


def tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_trace_noop():
    for empty in (None, ""):
        with trace(empty):
            x = 1 + 1
        assert x == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    with trace(str(tmp_path / "traces")):
        torch.ones(4).add_(1)
    files = list((tmp_path / "traces").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("add_" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("min_size", [preprocess.MIN_SIZE, 0], ids=["as_shipped", "no_lower_gate"])
def test_process_file_matches_jax(corpus, monkeypatch, min_size):
    """The same verdict for every file; with the lower size gate at 0 every
    blob reaches parsing, tokenizing and the quality check."""
    monkeypatch.setattr(preprocess, "MIN_SIZE", min_size)
    monkeypatch.setattr(jax_preprocess, "MIN_SIZE", min_size)
    verdicts = {}
    for path in sorted(corpus.glob("*.mid")):
        for version in ("v1", "v2"):
            args = (str(path), version, True)
            ours = preprocess.process_file(args)
            assert ours == jax_preprocess.process_file(args), (path.name, version)
            verdicts[path.name, version] = ours[1]
    assert verdicts["huge.mid", "v2"] == "too_large"
    assert verdicts["garbage.mid", "v2"] in ("parse_error", "empty")
    if min_size:
        assert verdicts["bad_short.mid", "v2"] == "too_small"
    assert len(set(verdicts.values())) >= 4  # several reasons, each the JAX one


def test_worker_side_imports_no_torch():
    """A spawned preprocessing worker imports ``train.preprocess`` (and with
    it the codec and tokenizer), not torch: its start-up stays short."""
    import subprocess
    import sys

    code = ("import sys, midi_model_tpu_torch.train.preprocess as p; "
            "assert p.process_file and 'torch' not in sys.modules, sorted(sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr[-2000:]


def test_main_writes_the_jax_trees(corpus, tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    accepted, rejected = preprocess.main(
        ["--src", str(corpus), "--dst", str(ours), "--jobs", "2", "--batch", "8"])
    jax_preprocess.main(["--src", str(corpus), "--dst", str(theirs), "--jobs", "1"])
    got = tree(ours)
    assert got == tree(theirs)
    assert accepted == sum(k.startswith("processed/") for k in got)
    assert accepted + rejected == len(list(corpus.glob("*.mid")))
    assert {"bad/too_small", "bad/too_large"} <= {str(Path(k).parent) for k in got}
