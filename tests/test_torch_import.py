"""The port imports with jax blocked, ships its kernel sources, and never
falls back from a non-CPU tensor to a plain version."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from midi_model_tpu_torch.ops import _build
from midi_model_tpu_torch.ops import attention as at
from midi_model_tpu_torch.ops import paged_allheads as pa
from midi_model_tpu_torch.ops import sampler as sp

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ["sampler.cu", "paged_decode.cu", "causal_attention.cu"]


def test_import_whole_port_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any import of jax now raises
        import midi_model_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            midi_model_tpu_torch.__path__, "midi_model_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules if m.startswith("midi_model_tpu."))
        allowed = ("midi_model_tpu.tokenizer", "midi_model_tpu.midi")
        bad = [m for m in loaded if not m.startswith(allowed)]
        assert not bad, bad
        assert "triton" not in sys.modules
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_sources_exist_with_note(name):
    src = (_build.CSRC / name).read_text()
    head = src[:3000]
    assert "Replaces:" in head and "midi_model_tpu/ops/" in head
    assert "bounds it on an H100" in head
    assert 'extern "C"' in src
    assert "torch/extension.h" not in src and "triton" not in src


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command(Path("/nonexistent/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-std=c++17" in cmd and "-O3" in cmd
    assert sorted(Path(c).name for c in cmd if c.endswith(".cu")) == sorted(KERNELS)
    # the library is keyed by the sources and lives under build/
    lib = _build.library_path()
    assert lib.parent == ROOT / "build" / "midi_model_tpu_torch"
    assert _build._source_hash() in lib.name


def test_wrappers_raise_on_non_cpu_tensors():
    """A tensor off the CPU goes to the kernel or raises: the meta device
    has no kernel, so every wrapper must raise instead of running the plain
    version."""
    meta = dict(device="meta")
    probs = torch.empty((2, 16), **meta)
    with pytest.raises(ValueError):
        sp.sample_top_p_k(probs, torch.empty(2, **meta),
                          torch.empty(2, dtype=torch.int32, **meta),
                          torch.empty((2, 8), **meta))
    q = torch.empty((1, 4, 2, 32), **meta)
    with pytest.raises(ValueError):
        at.causal_attention(q, q, q)
    pools = pa.PagedPools(torch.empty((4, 16, 128), **meta),
                          torch.empty((4, 16, 128), **meta))
    lengths = torch.empty(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        pa.paged_attention_stats(torch.empty((1, 4, 32), **meta), pools,
                                 lengths, lengths, page_size=16,
                                 pages_per_slot=4, kv_heads=4, head_dim=32)
    # mixing devices raises too
    with pytest.raises(ValueError):
        at.causal_attention(torch.zeros((1, 4, 2, 32)), q, q)
    assert not _build.LAUNCHES


def test_plain_versions_do_not_count_launches():
    _build.LAUNCHES.clear()
    q = torch.randn((1, 5, 2, 32))
    at.causal_attention(q, q, q)
    sp.sample_top_p_k(torch.rand((2, 16)), torch.full((2,), 0.9),
                      torch.full((2,), 4, dtype=torch.int32),
                      torch.zeros((2, 8)))
    assert sum(_build.LAUNCHES.values()) == 0
