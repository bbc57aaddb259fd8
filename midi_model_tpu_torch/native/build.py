"""Build the native extensions with g++ against the Python headers alone.

    python -m midi_model_tpu_torch.native.build

Each ``<name>.cpp`` compiles to ``build/midi_model_tpu_torch/native/`` at
the checkout root (gitignored), as ``_<name>_<hash><EXT_SUFFIX>``: the hash
is of the source, so an edited source builds anew and an unchanged one is
built once per machine.  ``utils.build.build_once`` compiles to a
temporary name and moves it into place, so processes that reach first use
together (test workers, the preprocessing pool) never load a half-written
library.
"""

from __future__ import annotations

import hashlib
import subprocess
import sysconfig
from pathlib import Path

from ..utils.build import build_once

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "midi_model_tpu_torch" / "native"
MODULES = ("midicodec", "tokenizer_scan")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((HERE / f"{name}.cpp").read_bytes()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_{name}_{digest}{suffix}"


def gxx_command(name: str, out: Path) -> list:
    include = sysconfig.get_paths()["include"]
    return ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{include}",
            str(HERE / f"{name}.cpp"), "-o", str(out)]


def build_one(name: str, verbose: bool = False) -> Path:
    """Compile ``<name>.cpp`` unless its library exists; return the path.
    Raises ``OSError`` without g++ and ``CalledProcessError`` on a failed
    compile."""

    def compile_to(tmp: Path) -> None:
        cmd = gxx_command(name, tmp)
        if verbose:
            print(" ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=not verbose)

    return build_once(library_path(name), compile_to)


def build(verbose: bool = True) -> list:
    return [build_one(name, verbose) for name in MODULES]


if __name__ == "__main__":
    paths = build()
    from . import native_codec, native_tokenizer_scan

    codec, scan = native_codec(), native_tokenizer_scan()
    assert codec.midi2opus(b"") == [1000, []]
    state = scan.scan_tracks([480, [["note", 0, 480, 0, 60, 90]]], 2, 4.0, 4.0)
    assert state["event_list"] == [["note", 0, 0, 0, 0, 60, 90, 16]], state
    print(f"built + smoke-tested {[p.name for p in paths]}")
