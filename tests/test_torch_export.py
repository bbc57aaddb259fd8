"""The port's ``torch.export`` artifacts and their runner on the CPU,
mirroring ``tests/test_export.py``: the loaded ``event_forward`` program
equals the JAX package's live ``midinet.forward`` with a cache within 1e-5
and returns the index 1; the token programs equal the port's
``forward_token``; ``ArtifactGenerator``'s greedy rows equal JAX's and the
port's ``generate``; the programs load and run with the port and jax
blocked; the copied numpy sampler equals the JAX module's.  The programs
are exported once for the module."""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midi_model_tpu.models import midinet as jmidinet
from midi_model_tpu.models.llama import KVCache
from midi_model_tpu.sampling import generate as jax_generate
from midi_model_tpu.serve import artifact_runner as jrunner
from midi_model_tpu_torch.interop.export import export_artifacts, load_artifact
from midi_model_tpu_torch.models.llama import DenseCache
from midi_model_tpu_torch.sampling import generate
from midi_model_tpu_torch.serve import artifact_runner as runner

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)

MAX_SEQ = 32


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jcfg, cfg, params, model, _ = tiny_models(seed=0)
    out = tmp_path_factory.mktemp("artifacts")
    manifest = export_artifacts(model, cfg, str(out), batch_size=1, max_seq=MAX_SEQ,
                                dtype=torch.float32)
    return jcfg, cfg, params, model, out, manifest


def _zeros(cfg, seq):
    cache = DenseCache.zeros(cfg, 1, seq, torch.float32, "cpu")
    return cache.k, cache.v, torch.zeros((), dtype=torch.int32)


def test_export_and_reload(exported):
    jcfg, cfg, params, _, out, manifest = exported
    for name in ("event_forward", "token_first", "token_next"):
        assert (out / f"{name}.pt2").exists()
    assert (out / "model.safetensors").exists() and (out / "config.json").exists()
    m = json.loads((out / "manifest.json").read_text())
    assert m == manifest and m["dtype"] == "float32"
    assert m["functions"]["event_forward"] == {"tokens": [1, 1, 8], "cache_seq": MAX_SEQ}
    assert m["functions"]["token_first"] == m["functions"]["token_next"] == {"cache_seq": 8}

    # the loaded program computes the hidden of the live JAX model
    fn = load_artifact(str(out / "event_forward.pt2")).module()
    tokens = np.random.default_rng(0).integers(0, cfg.tokenizer.vocab_size, (1, 1, 8))
    with torch.no_grad():
        hidden, ck, cv, idx = fn(torch.as_tensor(tokens, dtype=torch.int32),
                                 *_zeros(cfg.net, MAX_SEQ))
    cache = KVCache.zeros(jcfg.net, 1, MAX_SEQ, jnp.float32)
    ref_hidden, ref_cache = jmidinet.forward(params, jcfg, jnp.asarray(tokens, jnp.int32),
                                             cache=cache)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), atol=1e-5)
    np.testing.assert_allclose(ck.numpy(), np.asarray(ref_cache.k), atol=1e-5)
    assert int(idx) == 1 and idx.dtype == torch.int32


def test_token_programs_match_forward_token(exported):
    """token_first then token_next against the port's ``forward_token`` over
    the same prefix, with the cache carried between the calls."""
    _, cfg, _, model, out, _ = exported
    first = load_artifact(str(out / "token_first.pt2")).module()
    nxt = load_artifact(str(out / "token_next.pt2")).module()
    rng = np.random.default_rng(1)
    hidden = torch.as_tensor(rng.standard_normal((1, cfg.n_embd)), dtype=torch.float32)
    toks = torch.as_tensor(rng.integers(0, cfg.tokenizer.vocab_size, (1, 3)),
                           dtype=torch.int32)
    with torch.no_grad():
        logits, k, v, idx = first(hidden, *_zeros(cfg.net_token, 8))
        steps = [logits[:, -1]]
        for j in range(3):
            logits, k, v, idx = nxt(toks[:, j:j + 1], k, v, idx)
            steps.append(logits[:, -1])
        ref, _ = model.forward_token(hidden, toks)
    assert int(idx) == 4
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), ref.numpy(), atol=1e-5)


def test_artifact_generation_matches_greedy(exported):
    """The host-driven loop over the programs reproduces JAX's and the
    port's ``generate`` token for token under greedy decoding."""
    jcfg, cfg, params, model, out, _ = exported
    gen = runner.ArtifactGenerator(str(out), device="cpu")
    max_len = 10
    art = gen.generate(max_len=max_len, greedy=True)
    ref = jax_generate(params, jcfg, batch_size=1, max_len=max_len, greedy=True)
    ours = generate(model, cfg, batch_size=1, max_len=max_len, greedy=True)
    assert art.shape[1] > 1
    np.testing.assert_array_equal(art, ref)
    np.testing.assert_array_equal(art, ours)
    sampled = gen.generate(max_len=6, seed=3)
    assert sampled.shape[1] >= 2 and (sampled == gen.generate(max_len=6, seed=3)).all()
    with pytest.raises(ValueError, match="exported for"):
        runner.ArtifactGenerator(str(out), device="meta")


def test_programs_run_without_the_port(exported):
    """The .pt2 files need torch alone: loaded and run in a process where
    the port and jax cannot be imported, they give the in-process outputs."""
    _, cfg, _, _, out, _ = exported
    tokens = np.random.default_rng(2).integers(0, cfg.tokenizer.vocab_size, (1, 1, 8))
    fn = load_artifact(str(out / "event_forward.pt2")).module()
    with torch.no_grad():
        want = fn(torch.as_tensor(tokens, dtype=torch.int32), *_zeros(cfg.net, MAX_SEQ))[0]
    code = textwrap.dedent(f"""
        import sys
        for blocked in ("jax", "midi_model_tpu", "midi_model_tpu_torch"):
            sys.modules[blocked] = None
        import torch
        fn = torch.export.load({str(out / "event_forward.pt2")!r}).module()
        k = torch.zeros((4, 1, {MAX_SEQ}, 4, 16))
        with torch.no_grad():
            h, _, _, idx = fn(torch.tensor({tokens.tolist()}, dtype=torch.int32), k, k.clone(),
                              torch.zeros((), dtype=torch.int32))
        for name in ("token_first", "token_next"):
            torch.export.load({str(out)!r} + f"/{{name}}.pt2")
        assert int(idx) == 1
        torch.save(h, {str(out / "h.pt")!r})
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    torch.testing.assert_close(torch.load(out / "h.pt"), want, rtol=0, atol=0)


def test_numpy_sampler_copy_matches_jax_module():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    probs = runner.numpy_softmax(logits)
    np.testing.assert_array_equal(probs, jrunner.numpy_softmax(logits))
    for top_p, top_k in ((0.98, 20), (0.5, 50), (1.0, 1)):
        a = runner.numpy_sample_top_p_k(probs, top_p, top_k, np.random.RandomState(7))
        b = jrunner.numpy_sample_top_p_k(probs, top_p, top_k, np.random.RandomState(7))
        np.testing.assert_array_equal(a, b)
