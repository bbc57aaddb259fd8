"""The port's whole-step event-net decode (``ops.fused_step``, its plain
version on the CPU) against the JAX package's Pallas fused-step kernel in
interpret mode, at that kernel's test geometry (4 layers, 4 heads x 128,
pages of 16, bf16 weights and pools).

Hidden states and the appended pool rows agree within 3e-2 (the bound the
JAX package holds its kernel to; the two sides round their bf16 products
and softmax weights at the same points but sum in another order); every
other pool row is bit-identical to what it was.

On int8 pools (the kernel's quantized form, as ``tests/test_fused_step.py``
holds it): hidden within 3e-2; the appended rows' scales within rtol 2e-2
and their dequantized values within 3e-2 plus one quantization step — the
bf16 rows' tolerance above, and half a step of rounding on each side (a
raw int8 comparison would not do: where the two sides' bf16 rows round a
row's absmax, and so its scale, one bf16 step apart, a value near the
absmax moves by two int8 steps for the same value); inactive slots append
nothing and every other row, scale rows included, is bit-identical to what
it was."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.ops import fused_step as jfs
from midi_model_tpu.ops import paged_allheads as jpa
from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.ops import fused_step as fs
from midi_model_tpu_torch.ops import paged_allheads as pa

from _torch_helpers import layout, one_torch_thread  # noqa: F401 (autouse)

GEOMETRY = dict(n_layer=4, n_head=4, n_embd=512, n_inner=256)
PS, PPS = 16, 4
CAP = PS * PPS
TOL = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.get_config("v2", True, **GEOMETRY)
    cfg = MIDIModelConfig.get_config("v2", True, **GEOMETRY)
    sd = synthesize_state_dict(layout(cfg), 11)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    jax_params_from_sd(sd, jcfg))
    model = params_from_state_dict(sd, cfg, dtype=torch.bfloat16, device="cpu")
    return jcfg, cfg, params, model


CASES = {
    "aligned": ([33, 33, 33, 33], None),
    "ragged_inactive": ([40, 7, 17, 0], [True, True, True, False]),
    # slot 0 at capacity: its clipped write position is a row the step reads
    "capacity": ([CAP, 20, 7, 33], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_step_matches_pallas_kernel(case, setup):
    jcfg, cfg, params, model = setup
    lengths, active = CASES[case]
    b = len(lengths)
    net = cfg.net
    w = net.num_heads * net.head_dim
    rng = np.random.default_rng(len(case))
    n_pages = net.num_layers * b * PPS
    k0, v0 = (rng.normal(size=(n_pages, PS, w)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(b, net.hidden_size)).astype(np.float32)
    index = np.asarray(lengths, np.int32)

    jpools = jpa.PagedPools(k=jnp.asarray(k0, jnp.bfloat16), v=jnp.asarray(v0, jnp.bfloat16))
    ref_h, ref_pools = jfs.fused_decode_step(
        jfs.prepare_fused(params["net"]), jcfg.net, jnp.asarray(x), jpools,
        jnp.asarray(index), None if active is None else jnp.asarray(active),
        page_size=PS, pages_per_slot=PPS, interpret=True)

    before = [torch.from_numpy(a).to(torch.bfloat16) for a in (k0, v0)]
    pools = pa.PagedPools(before[0].clone(), before[1].clone())
    h, out = fs.fused_decode_step(
        fs.prepare_fused(model.net), net, torch.from_numpy(x), pools,
        torch.from_numpy(index), None if active is None else torch.tensor(active),
        page_size=PS, pages_per_slot=PPS)
    assert out.k is pools.k  # updated in place
    np.testing.assert_allclose(h.float().numpy(), np.asarray(ref_h, np.float32), **TOL)

    # rows the step appends: every slot of every layer at clip(index, 0, cap-1)
    wpos = np.clip(index, 0, CAP - 1)
    written = np.zeros((n_pages, PS), bool)
    for li in range(net.num_layers):
        written[(li * b + np.arange(b)) * PPS + wpos // PS, wpos % PS] = True
    for ours, ref, orig in ((out.k, ref_pools.k, before[0]), (out.v, ref_pools.v, before[1])):
        ours, ref, orig = ours.float().numpy(), np.asarray(ref, np.float32), orig.float().numpy()
        np.testing.assert_allclose(ours[written], ref[written], **TOL)
        np.testing.assert_array_equal(ours[~written], orig[~written])
        np.testing.assert_array_equal(ref[~written], orig[~written])


@pytest.mark.parametrize("case", list(CASES))
def test_fused_step_int8_matches_pallas_kernel(case, setup):
    jcfg, cfg, params, model = setup
    lengths, active = CASES[case]
    b = len(lengths)
    net = cfg.net
    w = net.num_heads * net.head_dim
    rng = np.random.default_rng(10 + len(case))
    n_pages = net.num_layers * b * PPS
    k0, v0 = (rng.integers(-127, 128, (n_pages, PS, w)).astype(np.int8) for _ in range(2))
    s0 = (rng.random((n_pages, PS, pa.LANE)) * 0.05 + 1e-3).astype(np.float32)
    s0 = torch.from_numpy(s0).to(torch.bfloat16)
    x = rng.normal(size=(b, net.hidden_size)).astype(np.float32)
    index = np.asarray(lengths, np.int32)

    jpools = jpa.PagedPools(k=jnp.asarray(k0), v=jnp.asarray(v0),
                            scales=jnp.asarray(s0.float().numpy(), jnp.bfloat16))
    ref_h, ref_pools = jfs.fused_decode_step(
        jfs.prepare_fused(params["net"]), jcfg.net, jnp.asarray(x), jpools,
        jnp.asarray(index), None if active is None else jnp.asarray(active),
        page_size=PS, pages_per_slot=PPS, interpret=True)

    pools = pa.PagedPools(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()), s0.clone())
    h, out = fs.fused_decode_step(
        fs.prepare_fused(model.net), net, torch.from_numpy(x), pools,
        torch.from_numpy(index), None if active is None else torch.tensor(active),
        page_size=PS, pages_per_slot=PPS)
    assert out.k is pools.k and out.scales is pools.scales  # updated in place
    np.testing.assert_allclose(h.float().numpy(), np.asarray(ref_h, np.float32), **TOL)

    # rows the step appends: each ACTIVE slot of every layer at clip(index, 0, cap-1)
    wpos = np.clip(index, 0, CAP - 1)
    live = np.ones(b, bool) if active is None else np.asarray(active)
    written = np.zeros((n_pages, PS), bool)
    for li in range(net.num_layers):
        slots = np.arange(b)[live]
        written[(li * b + slots) * PPS + wpos[slots] // PS, wpos[slots] % PS] = True
    h_n, dh = net.num_heads, net.head_dim
    scales = (out.scales.float().numpy(), np.asarray(ref_pools.scales, np.float32))
    np.testing.assert_allclose(scales[0][written], scales[1][written], rtol=2e-2, atol=1e-5)
    for j, (ours, ref, orig) in enumerate(((out.k, ref_pools.k, k0), (out.v, ref_pools.v, v0))):
        ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
        orig = orig.astype(np.float32)
        # dequantized: [rows, H, dh] values times their head's scale
        deq = [(t[written].reshape(-1, h_n, dh)
                * sc[written][:, j * h_n:(j + 1) * h_n, None]) for t, sc in zip((ours, ref), scales)]
        step = np.maximum(*(sc[written][:, j * h_n:(j + 1) * h_n, None] for sc in scales))
        assert np.all(np.abs(deq[0] - deq[1]) <= TOL["atol"] + step)
        np.testing.assert_array_equal(ours[~written], orig[~written])
        np.testing.assert_array_equal(ref[~written], orig[~written])
    for sc in scales:
        np.testing.assert_array_equal(sc[~written], s0.float().numpy()[~written])


def test_prepare_fused_shapes(setup):
    _, cfg, _, model = setup
    fused = fs.prepare_fused(model.net)
    n, d, f = cfg.net.num_layers, cfg.net.hidden_size, cfg.net.intermediate_size
    w = cfg.net.num_heads * cfg.net.head_dim
    assert fused.wqkv.shape == (n, 3 * w, d) and fused.wo.shape == (n, d, w)
    assert fused.wgu.shape == (n, 2 * f, d) and fused.wd.shape == (n, d, f)
    assert fused.ln.shape == (n, 2, d) and fused.final_norm.shape == (d,)
    layer = model.net.layers[1]
    assert torch.equal(fused.wqkv[1, w:2 * w], layer.self_attn.k_proj.weight)
    assert torch.equal(fused.wgu[1, f:], layer.mlp.up_proj.weight)
    assert torch.equal(fused.ln[1, 1], layer.post_attention_layernorm.weight)


def test_unsupported_pools_and_heads_raise(setup):
    """int8 pools need their scale pool; GQA is outside the kernel (MHA only)."""
    _, cfg, _, model = setup
    fused = fs.prepare_fused(model.net)
    w = cfg.net.num_heads * cfg.net.head_dim
    kw = dict(page_size=PS, pages_per_slot=PPS)
    x, index = torch.zeros((2, cfg.net.hidden_size)), torch.zeros(2, dtype=torch.int32)
    int8 = torch.zeros((cfg.net.num_layers * 2 * PPS, PS, w), dtype=torch.int8)
    with pytest.raises(TypeError):
        fs.fused_decode_step(fused, cfg.net, x, pa.PagedPools(int8, int8), index, **kw)
    scales = torch.zeros((*int8.shape[:2], pa.LANE), dtype=torch.bfloat16)
    x1 = torch.from_numpy(np.random.default_rng(1).normal(size=x.shape).astype(np.float32))
    h, _ = fs.fused_decode_step(fused, cfg.net, x1, pa.PagedPools(int8, int8.clone(), scales),
                                index, **kw)
    assert h.shape == x.shape and bool(int8.any())  # the int8 form runs and appends
    gqa = MIDIModelConfig.get_config("v2", True, **GEOMETRY).net
    gqa = type(gqa)(**{**gqa.__dict__, "num_kv_heads": 2})
    pools = pa.PagedPools(int8.to(torch.bfloat16), int8.to(torch.bfloat16))
    with pytest.raises(ValueError):
        fs.fused_decode_step(fused, gqa, x, pools, index, **kw)
