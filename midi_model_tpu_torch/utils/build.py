"""One build step shared by the port's compiled parts (the CUDA library in
``ops/_build.py``, the native extensions in ``native/build.py``)."""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Callable


def build_once(out: Path, compile_to: Callable[[Path], None]) -> Path:
    """Return ``out``, first running ``compile_to(tmp)`` and moving ``tmp``
    to ``out`` with ``os.replace`` if ``out`` does not exist yet.

    ``out`` is named by a hash of its sources, so an existing file is
    current.  Every process (and thread) that reaches the build together
    compiles to a temporary name of its own, so none ever loads a
    half-written file; the temporary is removed whatever happens, and
    ``compile_to``'s exception propagates."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        compile_to(tmp)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
