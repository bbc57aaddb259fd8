"""A small reader and writer of the ``.safetensors`` format, numpy and torch only.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, offsets relative to the byte after the header), then the
raw little-endian tensors.  The port keeps its own reader and writer because
the machine with the card has no ``safetensors`` package; the tests hold
both against it.

dtypes: F32, F16, BF16, I32, I64.  numpy has no bfloat16, so :func:`load_file`
returns BF16 tensors as float32 (exact), and :func:`save_file` writes a
torch bfloat16 tensor as BF16.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

_NUMPY = {"F32": np.float32, "F16": np.float16, "I32": np.int32, "I64": np.int64}
_FROM_NUMPY = {np.dtype(v).newbyteorder("<"): k for k, v in _NUMPY.items()}
_FROM_TORCH = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
               torch.int32: "I32", torch.int64: "I64"}
_MAX_HEADER = 100 << 20


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array (BF16 as
    float32)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if n > _MAX_HEADER or 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} out of range")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = info["dtype"], tuple(info["shape"])
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(body):
            raise ValueError(f"{path}: {name} lies outside the file")
        raw = body[begin:end]
        if dtype == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif dtype in _NUMPY:
            arr = np.frombuffer(raw, dtype=np.dtype(_NUMPY[dtype]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: {name} has dtype {dtype}, not one of "
                             f"{sorted(_NUMPY) + ['BF16']}")
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} holds {arr.size} values, shape {shape}")
        out[name] = arr.reshape(shape).astype(arr.dtype.newbyteorder("="), copy=True)
    return out


def _raw(value) -> tuple:
    """(dtype name, shape, little-endian bytes) of a numpy array or tensor."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype not in _FROM_TORCH:
            raise TypeError(f"no safetensors dtype for {t.dtype}")
        if t.dtype == torch.bfloat16:
            return "BF16", tuple(t.shape), t.view(torch.int16).numpy().astype("<i2").tobytes()
        value = t.numpy()
    arr = np.asarray(value)  # (np.ascontiguousarray would make a 0-d array 1-d)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    little = arr.dtype.newbyteorder("<")
    if little not in _FROM_NUMPY:
        raise TypeError(f"no safetensors dtype for {arr.dtype}")
    return _FROM_NUMPY[little], arr.shape, arr.astype(little, copy=False).tobytes()


def save_file(tensors: Dict[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays or torch tensors (F32, F16, BF16, I32, I64) to a
    ``.safetensors`` file, in name order, the header padded to 8 bytes."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    chunks, offset = [], 0
    for name in sorted(tensors):
        dtype, shape, raw = _raw(tensors[name])
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
