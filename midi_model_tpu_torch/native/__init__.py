"""Native (C++) host-side components: the MIDI decoder and the tokenizer's
scan phase.

``midicodec.cpp`` and ``tokenizer_scan.cpp`` are the port's copies of the
JAX package's ``native/`` sources (CPython extensions, no torch).  They are
built with g++ at first use, never at import (``build.py``), and loaded
from ``build/midi_model_tpu_torch/native/``.  Everything here has a Python
path with bit-identical output: where g++ is missing, the build fails, or
``MIDI_TPU_NATIVE=0`` is set, :func:`native_codec` and
:func:`native_tokenizer_scan` return None and the callers parse in Python.
The native path is a host-side throughput option (the data loader and the
preprocessing pool parse thousands of files a minute), never a requirement.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import threading

_modules: dict = {}  # name -> loaded module, or None after a failed build
_lock = threading.Lock()


def _load(name: str):
    if os.environ.get("MIDI_TPU_NATIVE", "1") == "0":
        return None
    if name in _modules:
        return _modules[name]
    with _lock:
        if name not in _modules:
            _modules[name] = _build_and_import(name)
    return _modules[name]


def _build_and_import(name: str):
    from .build import build_one

    try:
        path = build_one(name)
    except (OSError, subprocess.CalledProcessError):
        return None
    # the extension's init function is named by the module, not the file
    spec = importlib.util.spec_from_file_location(f"{__name__}._{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def native_codec():
    """The compiled ``_midicodec`` module, or None (not buildable, or
    disabled by ``MIDI_TPU_NATIVE=0``)."""
    return _load("midicodec")


def native_tokenizer_scan():
    """The compiled ``_tokenizer_scan`` module, or None."""
    return _load("tokenizer_scan")
