"""The port imports with jax and the JAX package blocked, ships its kernel
sources, runs on the card unless the caller names the CPU, and never falls
back from a non-CPU tensor to a plain version."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from midi_model_tpu_torch.ops import _build
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.midinet import MIDINet, init_model
from midi_model_tpu_torch.ops import attention as at
from midi_model_tpu_torch.ops import event_loop as el
from midi_model_tpu_torch.ops import fused_step as fs
from midi_model_tpu_torch.ops import paged_allheads as pa
from midi_model_tpu_torch.ops import sampler as sp
from midi_model_tpu_torch.ops import token_loop as tl
from midi_model_tpu_torch.sampling import build_mask_table, mask_tensors

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ["sampler.cu", "paged_decode.cu", "paged_decode_stream.cu",
           "causal_attention.cu", "causal_attention_bwd.cu", "token_loop.cu",
           "fused_step.cu", "event_loop.cu"]
# kernels no TPU kernel of the JAX package has: the hybrid event net's
HYBRID_KERNELS = ["ssm_scan.cu", "ssm_step.cu", "hybrid_norm.cu"]
# MHA with packed pages (4 heads x 32 = 128 lanes): the fused path's shapes
SMALL = MIDIModelConfig.get_config("v2", True, n_layer=4, n_head=4, n_embd=128,
                                   n_inner=128)


def _decode_inputs(model, device):
    """A token-row and a fused-step call's tensors for ``model`` on ``device``."""
    cfg = SMALL
    b, pps, ps = 2, 1, 16
    masks = mask_tensors(build_mask_table(cfg.tokenizer), device)
    hidden = torch.randn((b, cfg.n_embd), device=device)
    w = cfg.net.num_heads * cfg.net.head_dim
    shape = (cfg.net.num_layers * b * pps, ps, w)
    pools = pa.PagedPools(torch.zeros(shape, device=device),
                          torch.zeros(shape, device=device))
    index = torch.zeros(b, dtype=torch.int32, device=device)
    return masks, hidden, fs.prepare_fused(model.net), pools, index, dict(
        page_size=ps, pages_per_slot=pps)


def test_import_whole_port_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.modules["midi_model_tpu"] = None  # and of the JAX package
        import midi_model_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            midi_model_tpu_torch.__path__, "midi_model_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules if m.startswith("midi_model_tpu.")
                        or (m == "midi_model_tpu" and sys.modules[m] is not None))
        assert not loaded, loaded
        assert "triton" not in sys.modules and "safetensors" not in sys.modules
        # importing builds nothing and imports no UI toolkit
        assert "gradio" not in sys.modules and "fluidsynth" not in sys.modules
        from midi_model_tpu_torch import native
        assert native._modules == {}
        assert not any(m.endswith("._midicodec") or m.endswith("._tokenizer_scan")
                       for m in sys.modules)
        for new in ("train.cli", "train.trainer", "train.data", "train.checkpoint",
                    "train.metrics", "train.sched", "midi.codec", "midi.utils",
                    "interop.safetensors_io", "ops.attention", "models.api", "models.lora",
                    "interop.publish", "interop.export", "serve.artifact_runner",
                    "native", "native.build", "train.preprocess", "utils",
                    "utils.profiling", "utils.build", "serve.app", "serve.synth",
                    "parallel", "parallel.mesh", "sampling.sharded",
                    "parallel.collectives", "train.sharding"):
            assert "midi_model_tpu_torch." + new in names, new
        # the multi-process tests' rank programs load no jax either
        sys.path.insert(0, "tests")
        import _torch_mesh_worker  # noqa: F401
        import _torch_train_mesh_worker  # noqa: F401
        import _torch_multihost_worker  # noqa: F401
        loaded = sorted(m for m in sys.modules if m.startswith("midi_model_tpu.")
                        or (m == "midi_model_tpu" and sys.modules[m] is not None))
        assert not loaded and "jax" not in [m for m in sys.modules
                                            if sys.modules[m] is not None], loaded
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 41


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py imported as a module (its phases import the port
    inside their functions: run its imports by calling nothing) loads no
    jax and no module of the JAX package, and its main() refuses to run
    without a card."""
    code = textwrap.dedent("""
        import importlib.util, sys
        sys.modules["jax"] = None
        sys.modules["midi_model_tpu"] = None
        spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        import midi_model_tpu_torch.serve, midi_model_tpu_torch.sampling
        loaded = [m for m in sys.modules if m.startswith("midi_model_tpu.")]
        assert not loaded, loaded
        assert smoke.main() != 0  # no CUDA device here
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no CUDA device" in out.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` is the card: without one the entry points raise
    instead of running on the CPU; with ``device="cpu"`` they run there."""
    from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
    from midi_model_tpu_torch.models.llama import LlamaStack, resolve_device
    from midi_model_tpu_torch.serve import ContinuousBatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MIDINet(SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaStack(SMALL.net)
    layout = [(k, tuple(v.shape)) for k, v in
              MIDINet(SMALL, device="meta").state_dict().items()]
    sd = synthesize_state_dict(layout, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_state_dict(sd, SMALL)
    model = params_from_state_dict(sd, SMALL, device="cpu")
    assert model.device.type == "cpu"
    assert ContinuousBatcher(model, SMALL, n_slots=2, max_seq=64).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_app_defaults_to_the_card(monkeypatch, tmp_path):
    """The serving app's loader and ``main`` build on the card: without one,
    and without ``--device cpu``, they raise before any UI is built; the
    service follows the model's device."""
    from midi_model_tpu_torch.interop import save_file, synthesize_state_dict
    from midi_model_tpu_torch.serve import MidiGenerationService
    from midi_model_tpu_torch.serve import app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layout = [(k, tuple(v.shape)) for k, v in
              MIDINet(SMALL, device="meta").state_dict().items()]
    save_file(synthesize_state_dict(layout, 0), str(tmp_path / "model.safetensors"))
    SMALL.save_pretrained(str(tmp_path))
    ckpt = str(tmp_path / "model.safetensors")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.load_model(ckpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(["--ckpt", ckpt])
    assert app.resolve_batcher_slots(-1) == 32
    model, config = app.load_model(ckpt, device="cpu")
    service = MidiGenerationService(model, config, batch_size=1)
    assert service.device.type == "cpu" and model.dtype == torch.bfloat16


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_sources_exist_with_note(name):
    src = (_build.CSRC / name).read_text()
    head = src[:3000]
    assert "Replaces:" in head and "midi_model_tpu/ops/" in head
    assert "bounds it on an H100" in head
    assert 'extern "C"' in src
    assert "torch/extension.h" not in src and "triton" not in src


@pytest.mark.parametrize("name", HYBRID_KERNELS)
def test_hybrid_kernel_sources_exist_with_note(name):
    src = (_build.CSRC / name).read_text()
    head = src[:3000]
    assert "New for the hybrid event net" in head and "ops/" in head
    assert "What bounds" in head
    assert 'extern "C"' in src
    assert "torch/extension.h" not in src and "triton" not in src


def test_nvcc_command_targets_sm90a():
    compiles, link = _build.nvcc_commands(Path("/nonexistent/lib.so"))
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
    for cmd in compiles:  # one process per source, each to its own object
        assert "-c" in cmd and "-std=c++17" in cmd and "-O3" in cmd
    assert sorted(Path(cmd[-1]).name for cmd in compiles) == sorted(KERNELS + HYBRID_KERNELS)
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert len(set(objects)) == len(KERNELS + HYBRID_KERNELS) and set(objects) <= set(link)
    assert "-shared" in link and link[link.index("-o") + 1] == "/nonexistent/lib.so"
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
    model = MIDINet(SMALL, device="meta")
    masks, hidden, fused, pools, index, kw = _decode_inputs(model, "meta")
    with pytest.raises(ValueError):
        tl.decode_token_row(model, SMALL, hidden, masks, 1.0, 0.98, 20, None,
                            greedy=True)
    with pytest.raises(ValueError):
        fs.fused_decode_step(fused, SMALL.net, hidden, pools, index, **kw)
    with pytest.raises(ValueError):
        el.decode_event_block(model, SMALL, fused, hidden, pools, 0, masks, 1.0, 0.98,
                              20, None, n_events=2, greedy=True, **kw)
    with pytest.raises(ValueError):
        el.decode_event_block_ragged(model, SMALL, fused, hidden, pools, index,
                                     torch.ones(2, dtype=torch.bool, device="meta"), masks,
                                     1.0, 0.98, 20, None, n_events=2, greedy=True, **kw)
    for decode in (pa.paged_decode_cell, pa.paged_decode_stream):
        with pytest.raises(ValueError):
            decode(torch.empty((1, 4, 32), **meta), pools, lengths, lengths, page_size=16,
                   pages_per_slot=4, kv_heads=4, head_dim=32)
    with pytest.raises(ValueError):  # the cell kernel's side of the length rule
        pa.paged_attention_stats(torch.empty((1, 4, 32), **meta), pools, lengths, lengths,
                                 page_size=16, pages_per_slot=4, kv_heads=4, head_dim=32,
                                 max_length=1)
    # mixing devices raises too
    with pytest.raises(ValueError):
        at.causal_attention(torch.zeros((1, 4, 2, 32)), q, q)
    lse = torch.empty((1, 2, 4), **meta)
    with pytest.raises(ValueError):  # the backward kernel's wrapper
        at.causal_attention_backward(q, q, q, q, q, lse)
    int8 = pa.PagedPools(*(torch.empty((4 * 2, 16, 128), dtype=torch.int8, **meta)
                           for _ in range(2)),
                         torch.empty((4 * 2, 16, 128), dtype=torch.bfloat16, **meta))
    with pytest.raises(ValueError):  # the whole step's int8 form
        fs.fused_decode_step(fused, SMALL.net, hidden, int8, index, **kw)
    assert not _build.LAUNCHES


def test_plain_versions_do_not_count_launches():
    _build.LAUNCHES.clear()
    q = torch.randn((1, 5, 2, 32))
    at.causal_attention(q, q, q)
    qg = q.clone().requires_grad_(True)
    at.causal_attention(qg, qg, qg).sum().backward()  # the plain backward
    assert qg.grad is not None
    sp.sample_top_p_k(torch.rand((2, 16)), torch.full((2,), 0.9),
                      torch.full((2,), 4, dtype=torch.int32),
                      torch.zeros((2, 8)))
    model = init_model(SMALL, seed=0, device="cpu")
    masks, hidden, fused, pools, index, kw = _decode_inputs(model, "cpu")
    row, ended = tl.decode_token_row(model, SMALL, hidden, masks, 1.0, 0.98, 20,
                                     None, greedy=True)
    assert row.shape == (2, SMALL.tokenizer.max_token_seq) and ended.shape == (2,)
    h, _ = fs.fused_decode_step(fused, SMALL.net, hidden, pools, index, **kw)
    assert h.shape == hidden.shape and bool(pools.k.any())  # appended in place
    rows, h, _ = el.decode_event_block(model, SMALL, fused, hidden, pools, 1, masks,
                                       1.0, 0.98, 20, None, n_events=2, greedy=True, **kw)
    assert rows.shape == (2, 2, SMALL.tokenizer.max_token_seq) and h.shape == hidden.shape
    rows, h, _ = el.decode_event_block_ragged(
        model, SMALL, fused, hidden, pools, torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([True, False]), masks, 1.0, 0.98, 20, None, n_events=2, greedy=True,
        **kw)
    assert rows.shape == (2, 2, SMALL.tokenizer.max_token_seq) and not h[1].any()
    assert sum(_build.LAUNCHES.values()) == 0
