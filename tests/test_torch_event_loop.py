"""The port's whole-event loop (``ops.event_loop``, its plain version on the
CPU) against the JAX package's Pallas event-loop kernel in interpret mode
(``merged_decode_events``), at the JAX fused-step test's geometry (4
layers, 4 heads x 128 = packed pages), from the port's prefill state and
with shared noise; and the fused decode loop's blocks against its
per-event steps.

Rows are identical.  The hidden after the last event and the appended pool
rows agree within 1e-4 with f32 weights (sums in another order), and within
3e-2 with bf16 weights (the JAX package's bound between its event loop and
its per-event kernels); every other pool row is bit-identical.  Sampled rows
are compared with f32 weights: with bf16 weights the two sides' rounding of
sums taken in another order moves the probabilities by a few bf16 steps,
enough to change a Gumbel draw between near-equal candidates."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.models.llama import rms_norm as jax_rms_norm
from midi_model_tpu.ops import event_loop as jel
from midi_model_tpu.ops import paged_allheads as jpa
from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.midinet import init_model
from midi_model_tpu_torch.ops import event_loop as el
from midi_model_tpu_torch.ops import fused_step as fs
from midi_model_tpu_torch.sampling import (K_CAP, build_mask_table, decode_events,
                                           generate, mask_tensors, prefill)
from midi_model_tpu_torch.sampling.generate import Masks

from _torch_helpers import layout, one_torch_thread  # noqa: F401 (autouse)

GEOMETRY = dict(n_layer=4, n_head=4, n_embd=512, n_inner=256)
TOL = dict(atol=3e-2, rtol=3e-2)
B, P_LEN = 4, 5


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.get_config("v2", True, **GEOMETRY)
    cfg = MIDIModelConfig.get_config("v2", True, **GEOMETRY)
    sd = synthesize_state_dict(layout(cfg), 0)
    params = jax_params_from_sd(sd, jcfg)
    bf16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    models = {"f32": (params, params_from_state_dict(sd, cfg, device="cpu")),
              "bf16": (bf16, params_from_state_dict(sd, cfg, dtype=torch.bfloat16,
                                                      device="cpu"))}
    prompt = np.random.default_rng(8).integers(3, 20, (B, P_LEN, cfg.tokenizer.max_token_seq))
    return jcfg, cfg, models, models["bf16"][1], prompt


def _np(t):
    return t.float().numpy()


CASES = {"f32_greedy": ("f32", True, 1e-4), "f32_sampled": ("f32", False, 1e-4),
         "bf16_greedy": ("bf16", True, 3e-2)}


@pytest.mark.parametrize("case", list(CASES))
def test_event_block_matches_pallas_kernel(case, setup):
    jcfg, cfg, models, _, prompt = setup
    dtype, greedy, tol = CASES[case]
    params, model = models[dtype]
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tok = cfg.tokenizer
    n_ev, t_max = 2, tok.max_token_seq
    state = prefill(model, cfg, prompt, P_LEN + n_ev)
    n_pages, ps, _ = state.pools.k.shape
    pps = n_pages // (cfg.net.num_layers * B)
    table = build_mask_table(tok)
    if greedy:
        gumbel = np.zeros((n_ev, t_max * B, K_CAP), np.float32)
    else:
        keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(7), s))(
            jnp.arange(n_ev))
        gumbel = np.array(jax.vmap(lambda k: jax.random.gumbel(
            k, (t_max * B, K_CAP), jnp.float32))(keys))

    jmasks = tuple(jnp.asarray(m) for m in (table.first, table.steps, table.pad_only))
    merged = jel.prepare_inputs(params, jcfg, jmasks, stream_tok_mlp=False)
    jpools = jpa.PagedPools(k=jnp.asarray(_np(state.pools.k), jdtype),
                            v=jnp.asarray(_np(state.pools.v), jdtype))
    ref_rows, xout, ref_pools = jel.merged_decode_events(
        merged, jcfg, jnp.asarray(_np(state.hidden), jdtype), jpools, P_LEN, 1.0, 0.98,
        20, jnp.asarray(gumbel), page_size=ps, pages_per_slot=pps, n_events=n_ev,
        greedy=greedy, interpret=True)
    ref_hidden = jax_rms_norm(xout, merged["final_norm"], jcfg.net.rms_norm_eps)

    before = [_np(t) for t in (state.pools.k, state.pools.v)]
    rows, hidden, pools = el.decode_event_block(
        model, cfg, fs.prepare_fused(model.net), state.hidden, state.pools, P_LEN,
        mask_tensors(table, "cpu"), 1.0, 0.98, 20,
        None if greedy else torch.from_numpy(gumbel), n_events=n_ev, greedy=greedy,
        page_size=ps, pages_per_slot=pps)
    assert rows.shape == (n_ev, B, t_max) and rows.dtype == torch.int32
    assert pools.k is state.pools.k  # updated in place
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    np.testing.assert_allclose(_np(hidden), np.asarray(ref_hidden, np.float32),
                               atol=tol, rtol=tol)
    # rows appended: positions P_LEN .. P_LEN + n_ev - 1 of every slot and layer
    written = np.zeros(before[0].shape[:2], bool)
    for li in range(cfg.net.num_layers):
        for pos in range(P_LEN, P_LEN + n_ev):
            written[(li * B + np.arange(B)) * pps + pos // ps, pos % ps] = True
    for ours, ref, orig in zip((pools.k, pools.v), (ref_pools.k, ref_pools.v), before):
        ours, ref = _np(ours), np.asarray(ref, np.float32)
        np.testing.assert_allclose(ours[written], ref[written], atol=tol, rtol=tol)
        np.testing.assert_array_equal(ours[~written], orig[~written])


@pytest.mark.parametrize("greedy", [True, False])
def test_blocks_equal_per_event_steps(greedy, setup, monkeypatch):
    """decode_events on the fused path with blocks of 4 events (2 blocks and
    a 3-event tail) equals one event at a time: same rows, same hidden, same
    pools (the plain versions compute the same ops either way)."""
    _, cfg, _, model, prompt = setup
    masks = mask_tensors(build_mask_table(cfg.tokenizer, disable_eos=True), "cpu")

    def run(events_per_launch):
        monkeypatch.setattr(el, "EVENTS_PER_LAUNCH", events_per_launch)
        state = prefill(model, cfg, prompt, P_LEN + 11)
        gen = torch.Generator().manual_seed(5)
        return decode_events(model, cfg, state, masks, 11, 1.0, 0.98, 20, gen,
                             greedy=greedy, fused=True)

    (s_blk, rows_blk, n_blk), (s_one, rows_one, n_one) = run(4), run(1)
    assert n_blk == n_one == 11 and s_blk.cur_len == s_one.cur_len == P_LEN + 11
    assert torch.equal(rows_blk, rows_one)
    assert torch.equal(s_blk.hidden, s_one.hidden)
    assert torch.equal(s_blk.pools.k, s_one.pools.k)


def test_all_eos_event_ends_the_block(setup, monkeypatch):
    """When every row emits eos at an event, the block keeps that event's
    rows and stops the chunk, as one event at a time does."""
    _, cfg, _, model, prompt = setup
    tok = cfg.tokenizer
    table = build_mask_table(tok)
    first = np.zeros_like(table.first)
    first[tok.eos_id] = True  # eos is the only legal first token
    masks = Masks(*(torch.as_tensor(x) for x in (first, table.steps, table.pad_only)))
    out = []
    for events_per_launch in (4, 1):
        monkeypatch.setattr(el, "EVENTS_PER_LAUNCH", events_per_launch)
        state = prefill(model, cfg, prompt, P_LEN + 8)
        state, rows, n_done = decode_events(model, cfg, state, masks, 8, 1.0, 0.98, 20,
                                            None, greedy=True, fused=True)
        assert n_done == 1 and state.all_eos and state.cur_len == P_LEN + 1
        assert (rows[:, 0, 0] == tok.eos_id).all() and (rows[:, 1:] == tok.pad_id).all()
        out.append(rows)
    assert torch.equal(*out)


def test_default_rule_follows_the_kernels_limits(monkeypatch):
    """``fused=None`` takes the fused path only where every fused kernel
    runs: tv2o-medium up to 256 slots of 16384 rows; above that, or with a
    token net wider than 256 per head, the split path."""
    medium = MIDIModelConfig.from_name("tv2o-medium")
    assert el.why_not_fused(medium, 256, 16384) is None
    assert "256" in el.why_not_fused(medium, 257, 1024)
    assert el.why_not_fused(medium, 32, 16384 + 64) is not None
    wide_token = MIDIModelConfig.get_config("v2", True, **GEOMETRY)  # 1 head x 512
    assert "head_dim" in el.why_not_fused(wide_token, 4, 1024)

    # a small model inside every limit: 8 x 64 event heads, 2 x 256 token heads
    cfg = MIDIModelConfig.get_config("v2", True, n_layer=1, n_head=8, n_embd=512,
                                     n_inner=64)
    model = init_model(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    taken = []
    gen_mod = importlib.import_module("midi_model_tpu_torch.sampling.generate")
    monkeypatch.setattr(gen_mod, "prepare_fused",
                        lambda stack: taken.append(True) or fs.prepare_fused(stack))
    for batch, fused in ((2, True), (257, False)):
        taken.clear()
        rows = generate(model, cfg, batch_size=batch, max_len=2, greedy=True)
        assert rows.shape == (batch, 2, cfg.tokenizer.max_token_seq)
        assert bool(taken) == fused, batch
