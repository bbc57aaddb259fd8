"""The port's ragged event loop (``ops.event_loop.decode_event_block_ragged``,
its plain version on the CPU) against the JAX package's Pallas kernel in
its ragged form (``merged_decode_ragged``, interpret mode), at the JAX
merged-kernel tests' geometry (4 layers, 4 heads x 128: packed pages), with
f32 weights and the same numpy noise on both sides.

The batch: mixed lengths over random pools, one slot inactive at entry,
one that reaches the capacity after 3 events, per-slot temp / top_p /
top_k, allow planes, and two slots that may start a row only with eos or a
note, at a high temperature, so eos is drawn mid-block.  Rows identical;
the hidden after the last event (retired slots frozen, a slot dead at
entry 0) and the appended pool rows within 1e-4 (f32 sums in another
order); every other pool row bit-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.models.llama import rms_norm as jax_rms_norm
from midi_model_tpu.ops import event_loop as jel
from midi_model_tpu.ops import paged_allheads as jpa
from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.ops import event_loop as el
from midi_model_tpu_torch.ops import fused_step as fs
from midi_model_tpu_torch.ops import paged_allheads as pa
from midi_model_tpu_torch.sampling import K_CAP, build_allow_vector, build_mask_table, mask_tensors

from _torch_helpers import layout, one_torch_thread  # noqa: F401 (autouse)

GEOMETRY = dict(n_layer=4, n_head=4, n_embd=512, n_inner=256)
PS, PPS = 8, 4
CAP = PS * PPS
N_EV = 4
INDEX = np.array([3, 11, CAP - 3, 17, 6, 20], np.int32)  # slot 2 hits the capacity
ACTIVE = np.array([True, False, True, True, True, True])  # slot 1 dead at entry
EOS_SLOTS = [4, 5]
B = len(INDEX)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.get_config("v2", True, **GEOMETRY)
    cfg = MIDIModelConfig.get_config("v2", True, **GEOMETRY)
    sd = synthesize_state_dict(layout(cfg), 0)
    return jcfg, cfg, jax_params_from_sd(sd, jcfg), params_from_state_dict(sd, cfg,
                                                                           device="cpu")


def _inputs(tok):
    rng = np.random.default_rng(12)
    temp = np.array([1.0, 0.8, 1.0, 1.2, 1e3, 1e3], np.float32)
    top_p = np.array([0.98, 0.9, 1.0, 0.5, 1.0, 1.0], np.float32)
    top_k = np.array([20, 8, 128, 64, 128, 128], np.int32)
    allow = np.ones((B, tok.vocab_size), bool)
    allow[0] = build_allow_vector(tok, disable_patch_change=True, disable_channels=[1, 3])
    allow[2, tok.eos_id] = False  # slot 2 runs into the capacity
    allow[EOS_SLOTS] = True
    allow[np.ix_(EOS_SLOTS, [i for n, i in tok.event_ids.items() if n != "note"])] = False
    hidden = rng.normal(size=(B, GEOMETRY["n_embd"])).astype(np.float32)
    w = GEOMETRY["n_embd"]
    pools = [(rng.normal(size=(GEOMETRY["n_layer"] * B * PPS, PS, w)) * 0.5).astype(np.float32)
             for _ in range(2)]
    gumbel = rng.gumbel(size=(N_EV, tok.max_token_seq * B, K_CAP)).astype(np.float32)
    return temp, top_p, top_k, allow, hidden, pools, gumbel


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_ragged_block_matches_pallas_kernel(greedy, setup):
    jcfg, cfg, params, model = setup
    tok = cfg.tokenizer
    temp, top_p, top_k, allow, hidden, (k0, v0), gumbel = _inputs(tok)
    table = build_mask_table(tok)
    jmasks = tuple(jnp.asarray(m) for m in (table.first, table.steps, table.pad_only))
    merged = jel.prepare_inputs(params, jcfg, jmasks, stream_tok_mlp=False)
    noise = np.zeros_like(gumbel) if greedy else gumbel
    ref_rows, xout, ref_pools = jel.merged_decode_ragged(
        merged, jcfg, jnp.asarray(hidden), jpa.PagedPools(k=jnp.asarray(k0), v=jnp.asarray(v0)),
        jnp.asarray(INDEX), jnp.asarray(ACTIVE), jnp.asarray(allow, jnp.float32),
        jnp.asarray(temp), jnp.asarray(top_p), jnp.asarray(top_k), jnp.asarray(noise),
        page_size=PS, pages_per_slot=PPS, n_events=N_EV, greedy=greedy, interpret=True)
    ref_hidden = np.asarray(jax_rms_norm(xout, merged["final_norm"], jcfg.net.rms_norm_eps))
    ref_rows = np.asarray(ref_rows)

    pools = pa.PagedPools(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    rows, h, out = el.decode_event_block_ragged(
        model, cfg, fs.prepare_fused(model.net), torch.from_numpy(hidden), pools,
        torch.from_numpy(INDEX), torch.from_numpy(ACTIVE), mask_tensors(table, "cpu"),
        torch.from_numpy(temp), torch.from_numpy(top_p), torch.from_numpy(top_k),
        None if greedy else torch.from_numpy(gumbel), torch.from_numpy(allow),
        n_events=N_EV, greedy=greedy, page_size=PS, pages_per_slot=PPS)
    assert out.k is pools.k and rows.shape == (N_EV, B, tok.max_token_seq)
    np.testing.assert_array_equal(rows.numpy(), ref_rows)
    np.testing.assert_allclose(h.numpy(), ref_hidden, atol=1e-4, rtol=1e-4)

    # the batch's cases really happened
    lead = ref_rows[:, :, 0]
    assert (lead[:, 1] == tok.pad_id).all()  # dead at entry
    assert (lead[:3, 2] != tok.pad_id).all() and (lead[3:, 2] == tok.pad_id).all()  # capacity
    assert not h[1].any()
    if not greedy:
        assert any(lead[e, s] == tok.eos_id for e in range(1, N_EV) for s in EOS_SLOTS)
    # appended rows: slot s at INDEX[s] + e in every layer while it was alive
    written = np.zeros(k0.shape[:2], bool)
    for e, s in zip(*np.nonzero(lead != tok.pad_id)):
        pos = INDEX[s] + e
        written[(np.arange(GEOMETRY["n_layer"]) * B + s) * PPS + pos // PS, pos % PS] = True
    for ours, ref, orig in zip(out, ref_pools, (k0, v0)):
        ours, ref = ours.numpy(), np.asarray(ref, np.float32)
        np.testing.assert_allclose(ours[written], ref[written], atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(ours[~written], orig[~written])
        np.testing.assert_array_equal(ref[~written], orig[~written])


def test_uniform_batch_equals_aligned_block(setup):
    """Every slot alive at one length, nothing retiring (eos disabled): the
    ragged block equals the aligned block on the same inputs."""
    _, cfg, _, model = setup
    tok = cfg.tokenizer
    _, _, _, _, hidden, (k0, v0), gumbel = _inputs(tok)
    masks = mask_tensors(build_mask_table(tok, disable_eos=True), "cpu")
    fused = fs.prepare_fused(model.net)
    g = torch.from_numpy(gumbel)
    kw = dict(n_events=N_EV, greedy=False, page_size=PS, pages_per_slot=PPS)
    pools_a = pa.PagedPools(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    rows_a, h_a, _ = el.decode_event_block(model, cfg, fused, torch.from_numpy(hidden),
                                           pools_a, 9, masks, 1.0, 0.98, 20, g, **kw)
    pools_r = pa.PagedPools(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    rows_r, h_r, _ = el.decode_event_block_ragged(
        model, cfg, fused, torch.from_numpy(hidden), pools_r,
        torch.full((B,), 9, dtype=torch.int32), torch.ones(B, dtype=torch.bool), masks,
        1.0, 0.98, 20, g, **kw)
    assert torch.equal(rows_a, rows_r) and torch.equal(h_a, h_r)
    assert torch.equal(pools_a.k, pools_r.k) and torch.equal(pools_a.v, pools_r.v)


def test_int8_pools_name_the_missing_kernel():
    """The event loop takes pools of the weights' dtype only (as the JAX
    package's); the per-event pair takes int8 pools too."""
    medium = MIDIModelConfig.from_name("tv2o-medium")
    assert el.why_not_event_loop(medium, 32, 2048, torch.bfloat16) is None
    assert "int8" in el.why_not_event_loop(medium, 32, 2048, torch.int8)
    assert el.why_not_fused(medium, 32, 2048) is None

