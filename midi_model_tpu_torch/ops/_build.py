"""Build the port's CUDA kernels and bind them with ctypes.

All ``csrc/*.cu`` files compile in ONE ``nvcc`` call into a shared library
with a plain C interface (no PyTorch headers: a few seconds to build, where
a ``torch.utils.cpp_extension`` build takes minutes).  The library lives
under ``build/midi_model_tpu_torch/`` at the checkout root, keyed by a hash
of the sources, and is built at first use — never at import.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`call` raises if that is not 0.  Each kernel wrapper counts its own
launches in :data:`LAUNCHES` (one per launch, nowhere else), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "midi_model_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> launches since the caller last cleared it
LAUNCHES: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_PAGED = [_P] * 12 + [_I] * 7 + [_P]
_ATTN = [_P] * 4 + [_I] * 5 + [_P, _P]
_SIGNATURES = {
    "mm_sampler": [_P] * 5 + [_I] * 3 + [_P],
    "mm_paged_decode_f32": _PAGED,
    "mm_paged_decode_bf16": _PAGED,
    "mm_causal_attention_f32": _ATTN,
    "mm_causal_attention_bf16": _ATTN,
}


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmm_kernels_{_source_hash()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def nvcc_command(out: Path) -> List[str]:
    return ([_nvcc()] + ARCH_FLAGS
            + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(out)] + [str(p) for p in sorted(CSRC.glob("*.cu"))])


def build(verbose: bool = False) -> Path:
    """Compile the library if this source hash has none yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command(tmp)
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mm_error_string.argtypes = [ctypes.c_int]
    lib.mm_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, *args) -> None:
    """Launch ``name`` from the library on its arguments; raise on an error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.mm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs), False
    when every tensor lies on one CUDA device (the kernel runs); raise on
    anything else — there is no fallback from a CUDA tensor."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
