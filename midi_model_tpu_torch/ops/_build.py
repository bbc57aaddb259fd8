"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into a shared library
with a plain C interface (no PyTorch headers: seconds to build, where a
``torch.utils.cpp_extension`` build takes minutes).  The library lives
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
from typing import List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "midi_model_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> launches since the caller last cleared it
LAUNCHES: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_PAGED = [_P] * 16 + [_I] * 9 + [_P]  # both paged kernels
_ATTN = [_P] * 5 + [_I] * 5 + [_P, _P]
_ATTN_BWD = [_P] * 10 + [_I] * 5 + [_P, _P]
# the whole-step decode kernels take host arrays of pointers, ints and
# floats (their parameter structs, filled on the C side) and the stream
_PACKED = [_P] * 4
_SIGNATURES = {
    "mm_sampler": [_P] * 5 + [_I] * 3 + [_P],
    "mm_paged_decode_f32": _PAGED,
    "mm_paged_decode_bf16": _PAGED,
    "mm_paged_decode_int8": _PAGED,
    "mm_paged_decode_stream_f32": _PAGED,
    "mm_paged_decode_stream_bf16": _PAGED,
    "mm_paged_decode_stream_int8": _PAGED,
    "mm_causal_attention_f32": _ATTN,
    "mm_causal_attention_bf16": _ATTN,
    "mm_causal_attention_bwd_f32": _ATTN_BWD,
    "mm_causal_attention_bwd_bf16": _ATTN_BWD,
    "mm_token_row_f32": _PACKED,
    "mm_token_row_bf16": _PACKED,
    "mm_fused_step_f32": _PACKED,
    "mm_fused_step_bf16": _PACKED,
    "mm_fused_step_f32_int8": _PACKED,
    "mm_fused_step_bf16_int8": _PACKED,
    "mm_event_loop_f32": _PACKED,
    "mm_event_loop_bf16": _PACKED,
    "mm_event_loop_ragged_f32": _PACKED,
    "mm_event_loop_ragged_bf16": _PACKED,
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


def nvcc_commands(out: Path) -> Tuple[List[List[str]], List[str]]:
    """One compile command per source (run side by side), then the link of
    their objects into the library ``out``."""
    compiles, objects = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.with_name(f"{out.name}.{src.stem}.o")
        compiles.append([_nvcc()] + ARCH_FLAGS
                        + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c",
                           "-o", str(obj), str(src)])
        objects.append(str(obj))
    return compiles, [_nvcc()] + ARCH_FLAGS + ["-shared", "-o", str(out)] + objects


def build(verbose: bool = False) -> Path:
    """Compile the library if this source hash has none yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compiles, link = nvcc_commands(tmp)
    if verbose:
        for cmd in compiles:
            cmd[1:1] = ["-Xptxas", "-v"]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in compiles]
    # wait for every compile before raising: no nvcc outlives the build
    done = [(cmd, proc.communicate()[1], proc.returncode)
            for cmd, proc in zip(compiles, procs)]
    try:
        for cmd, err, code in done:
            _check_nvcc(cmd, code, err, verbose)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stderr, verbose)
        os.replace(tmp, out)
    finally:
        for cmd in compiles:
            Path(cmd[cmd.index("-o") + 1]).unlink(missing_ok=True)
    return out


def _check_nvcc(cmd: List[str], code: int, stderr: str, verbose: bool) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}) on {cmd[-1]}:\n{stderr}")
    if verbose:
        print(stderr)


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


def call_packed(name: str, ptrs, ints, floats, device: torch.device) -> None:
    """Launch a kernel that takes its parameters as three host arrays
    (pointers — a tensor's data pointer, or None for null — ints, floats)."""
    arrays = ((ctypes.c_void_p * len(ptrs))(*[p or None for p in ptrs]),
              (ctypes.c_int * len(ints))(*ints),
              (ctypes.c_float * len(floats))(*floats))
    call(name, *[ctypes.cast(a, ctypes.c_void_p) for a in arrays],
         stream_ptr(device))


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
