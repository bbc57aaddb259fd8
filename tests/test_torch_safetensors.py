"""The port's own ``.safetensors`` reader and writer
(``interop.safetensors_io``; the machine with the card has no
``safetensors`` package) against the ``safetensors`` package, both ways,
and the JAX package's ``load_state_dict`` reading what the port writes.
Values must be identical."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load, save_file as st_save
from safetensors.torch import load_file as st_load_torch, save_file as st_save_torch

from midi_model_tpu.interop import load_state_dict as jax_load_state_dict
from midi_model_tpu_torch.interop import load_file, load_state_dict, save_file

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def _arrays():
    rng = np.random.default_rng(0)
    return {"w.f32": rng.normal(size=(3, 5)).astype(np.float32),
            "w.f16": rng.normal(size=(4,)).astype(np.float16),
            "i.i32": rng.integers(-9, 9, (2, 2, 3)).astype(np.int32),
            "i.i64": rng.integers(-2**40, 2**40, (6,)).astype(np.int64),
            "scalar": np.array(3.5, np.float32),
            "empty": np.zeros((0, 4), np.float32)}


@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_numpy_dtypes_round_trip(tmp_path, writer):
    arrays = _arrays()
    path = str(tmp_path / "x.safetensors")
    (save_file if writer == "port" else st_save)(arrays, path)
    got = (st_load if writer == "port" else load_file)(path)
    assert sorted(got) == sorted(arrays)
    for name, want in arrays.items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        np.testing.assert_array_equal(got[name], want)


@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_bf16_round_trip(tmp_path, writer):
    """numpy has no bfloat16: the port writes torch bf16 tensors as BF16 and
    reads BF16 back as float32 (exact)."""
    t = {"b": torch.randn(7, 3).to(torch.bfloat16), "f": torch.randn(2)}
    path = str(tmp_path / "b.safetensors")
    (save_file if writer == "port" else st_save_torch)(t, path)
    if writer == "port":
        got = st_load_torch(path)
        assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], t["b"])
        assert torch.equal(got["f"], t["f"])
    else:
        got = load_file(path)
        assert got["b"].dtype == np.float32
        np.testing.assert_array_equal(got["b"], t["b"].float().numpy())


def test_metadata_and_header_layout(tmp_path):
    path = tmp_path / "m.safetensors"
    save_file({"a": np.ones(3, np.float32)}, str(path), metadata={"format": "pt", "n": 3})
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n % 8 == 0  # the header is padded to 8 bytes
    header = json.loads(raw[8:8 + n])
    assert header["__metadata__"] == {"format": "pt", "n": "3"}
    assert header["a"] == {"dtype": "F32", "shape": [3], "data_offsets": [0, 12]}
    np.testing.assert_array_equal(st_load(str(path))["a"], np.ones(3, np.float32))


def test_malformed_files_raise(tmp_path):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", 10**9) + b"{}")
    with pytest.raises(ValueError):
        load_file(str(path))
    header = json.dumps({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}).encode()
    path.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 8)
    with pytest.raises(ValueError):  # the tensor runs past the end of the file
        load_file(str(path))


def test_state_dicts_cross_between_packages(tmp_path):
    """A state dict the port writes loads through both packages'
    ``load_state_dict``; one the ``safetensors`` package writes loads
    through the port's."""
    sd = {k: v for k, v in _arrays().items() if v.dtype == np.float32}
    path = str(tmp_path / "model.safetensors")
    save_file(sd, path)
    for loaded in (load_state_dict(path), jax_load_state_dict(path)):
        assert sorted(loaded) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(np.asarray(loaded[k]), sd[k])
    st_save(sd, path)
    for k, v in load_state_dict(path).items():
        np.testing.assert_array_equal(v, sd[k])
