"""int8 paged pools and the streaming paged decode in the port against the
JAX package: pool helpers bit-identical, the plain decode (the port's plain
version of both the streaming and the cell kernel) against ``_decode_xla``
and against the Pallas streaming kernel in interpret mode, the rule that
picks the cell or the streaming kernel and the two wrappers' shared plain
version, and ``decode_paged`` with ``active`` on int8 pools and with one
int length.

Tolerances: against ``_decode_xla`` (both f32 over the same values; an
int8 value dequantizes to the same exact product on both sides) atol 1e-5;
against the Pallas kernel 2e-2, because that kernel feeds q and the
softmax weights to the matrix unit in bf16 (``build_q_diag``,
``paged_allheads.py:880-896``); ``decode_paged`` on f32 weights 1e-4 (the
two packages' f32 matmuls sum in another order), its appended int8 rows
within one step (a row quantized from values that differ at f32 epsilon
may round the other way)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midi_model_tpu.models import llama as jllama
from midi_model_tpu.ops import paged_allheads as jpa
from midi_model_tpu_torch.ops import paged_allheads as pa

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)

PS, PPS = 16, 8
CAP = PS * PPS
# empty, inactive (length 0, still appending), one full 4-page block plus a
# page, mid-page, one row, and a slot at capacity whose clipped write lands
# on a row the call reads
LENGTHS = np.array([0, 0, 5 * PS, 37, 1, CAP], np.int32)
B = len(LENGTHS)
N_PAGES = B * PPS + 3


def _pools(dtype, hkv, d, seed):
    """Random pools in both packages: (port pools, JAX pools)."""
    rng = np.random.default_rng(seed)
    w = hkv * pa.head_stride(d, hkv)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, (N_PAGES, PS, w)).astype(np.int8) for _ in range(2))
        sc = rng.uniform(1e-3, 0.05, (N_PAGES, PS, pa.LANE)).astype(np.float32)
        jsc = jnp.asarray(sc, jnp.bfloat16)
        pools = pa.PagedPools(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                              torch.from_numpy(np.asarray(jsc, np.float32)).to(torch.bfloat16))
        return pools, jpa.PagedPools(k=jnp.asarray(k), v=jnp.asarray(v), scales=jsc)
    raw = rng.normal(size=(2, N_PAGES, PS, hkv, d)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jk, jv = (jpa.pack_heads(jnp.asarray(x, jdt), hkv, d) for x in raw)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return (pa.PagedPools(*(torch.tensor(np.asarray(x, np.float32)).to(tdt) for x in (jk, jv))),
            jpa.PagedPools(k=jk, v=jv))


def _fresh_rows(dtype, hkv, d, seed):
    """Fresh packed rows (+ scale rows for int8) in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, B, hkv, d)).astype(np.float32)
    if dtype == "int8":
        (kq, ks), (vq, vs) = (jpa.quantize_packed(jnp.asarray(t), hkv, d) for t in x)
        jrows = (kq, vq, jpa.combine_scales(ks, vs, hkv))
        rows = tuple(torch.from_numpy(np.asarray(t, np.float32)).to(dt) for t, dt in
                     zip(jrows, (torch.int8, torch.int8, torch.bfloat16)))
        return rows, jrows
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jrows = tuple(jpa.pack_heads(jnp.asarray(t, jdt), hkv, d) for t in x) + (None,)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rows = tuple(torch.tensor(np.asarray(t, np.float32)).to(tdt) for t in jrows[:2]) + (None,)
    return rows, jrows


CASES = [(8, 4, 64), (4, 4, 64), (4, 1, 16)]  # GQA, MHA, padded head stride


@pytest.mark.parametrize("h,hkv,d", CASES)
def test_int8_pool_helpers_bit_identical(h, hkv, d):
    x = (np.random.default_rng(0).normal(size=(3, 5, hkv, d)) * 3).astype(np.float32)
    q, s = pa.quantize_packed(torch.from_numpy(x), hkv, d)
    jq, js = jpa.quantize_packed(jnp.asarray(x), hkv, d)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js, np.float32))
    row = pa.combine_scales(s, s * 2, hkv)
    np.testing.assert_array_equal(row.float().numpy(), np.asarray(
        jpa.combine_scales(js, js * 2, hkv), np.float32))
    ks, vs = pa.split_scales(row, hkv)
    assert torch.equal(ks, s) and torch.equal(vs, s * 2)
    pools = pa.alloc_pools(hkv, 7, PS, d, torch.bfloat16, torch.device("cpu"), quantized=True)
    jpools = jpa.alloc_pools(hkv, 7, PS, d, jnp.bfloat16, quantized=True)
    for ours, theirs in zip(pools, jpools):
        assert tuple(ours.shape) == theirs.shape and not ours.any()
        assert str(ours.dtype).split(".")[-1] == str(theirs.dtype)
    assert pools.quantized and pools.page_size == PS


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("h,hkv,d", CASES)
def test_plain_decode_and_append_match_jax(h, hkv, d, dtype):
    """The port's plain version (both CUDA kernels' reference) against
    ``_decode_xla`` (f32 math) and the Pallas streaming kernel (interpret
    mode), with the append of every slot's fresh row."""
    pools, jpools = _pools(dtype, hkv, d, seed=1)
    rows, jrows = _fresh_rows(dtype, hkv, d, seed=2)
    q = (np.random.default_rng(3).normal(size=(B, h, d)) * d ** -0.5).astype(np.float32)
    base = (np.arange(B) * PPS).astype(np.int32)
    write_pos = np.clip(LENGTHS, 0, CAP - 1)
    write_pos[1] = 9  # the inactive slot appends too (decode_paged's rule)
    wpages, woffs = (base + write_pos // PS).astype(np.int32), (write_pos % PS).astype(np.int32)
    kw = dict(page_size=PS, pages_per_slot=PPS, kv_heads=hkv, head_dim=d)

    o, m, l, out = pa.paged_attention_stats(
        torch.from_numpy(q), pools, torch.from_numpy(LENGTHS), torch.from_numpy(base),
        rows + (torch.from_numpy(wpages), torch.from_numpy(woffs)), **kw)
    assert out.k is pools.k  # in place
    jargs = (jnp.asarray(q), jpools, jnp.asarray(LENGTHS), jnp.asarray(base))
    o_x, m_x, l_x = jpa._decode_xla(*jargs, **kw)
    o_k, m_k, l_k, jout = jpa.paged_attention_stats(
        *jargs, jrows + (jnp.asarray(wpages), jnp.asarray(woffs)), ppcb=4,
        streaming=True, interpret=True, **kw)
    ref_pools = jpa.kv_append(jpools, jrows[0], jrows[1], jnp.asarray(wpages),
                              jnp.asarray(woffs), new_scales=jrows[2])
    for ours, a, b in zip(out, ref_pools, jout):
        if ours is None:
            continue
        ours = ours.float().numpy()
        np.testing.assert_array_equal(ours, np.asarray(a, np.float32))
        np.testing.assert_array_equal(ours, np.asarray(b, np.float32))

    live = LENGTHS > 0
    o, m, l = o.numpy(), m.numpy(), l.numpy()
    np.testing.assert_allclose(o, np.asarray(o_x), atol=1e-5)
    np.testing.assert_allclose(m[live], np.asarray(m_x)[live], atol=1e-5)
    np.testing.assert_allclose(l, np.asarray(l_x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o[live], np.asarray(o_k)[live], atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(m[live], np.asarray(m_k)[live], atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(l[live], np.asarray(l_k)[live], rtol=2e-2)
    assert np.all(m[~live] == -np.inf) and np.all(l[~live] == 0) and np.all(o[~live] == 0)


@pytest.mark.parametrize("max_length,kernel", [
    (None, "stream"), (0, "cell"), (pa.CELL_MAX_ROWS, "cell"),
    (pa.CELL_MAX_ROWS + 1, "stream")])
def test_paged_kernel_rule(max_length, kernel):
    """The cell kernel while the host knows every slot is short, else the
    streaming kernel (per-slot lengths the host does not know included)."""
    assert pa.paged_kernel(max_length) == kernel


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cell_and_stream_wrappers_share_the_plain_version(dtype):
    """On CPU tensors both kernels' wrappers and ``paged_attention_stats``
    (on either side of the length rule) give the same stats and appends."""
    h, hkv, d = 8, 4, 64
    q = torch.from_numpy((np.random.default_rng(3).normal(size=(B, h, d))
                          * d ** -0.5).astype(np.float32))
    base = torch.from_numpy((np.arange(B) * PPS).astype(np.int32))
    write_pos = np.clip(LENGTHS, 0, CAP - 1)
    rows, _ = _fresh_rows(dtype, hkv, d, seed=2)
    write = rows + (torch.from_numpy((base.numpy() + write_pos // PS).astype(np.int32)),
                    torch.from_numpy((write_pos % PS).astype(np.int32)))
    kw = dict(page_size=PS, pages_per_slot=PPS, kv_heads=hkv, head_dim=d)
    lengths = torch.from_numpy(LENGTHS)
    outs = []
    for call in (pa.paged_decode_cell, pa.paged_decode_stream,
                 lambda *a, **k: pa.paged_attention_stats(*a, max_length=1, **k),
                 lambda *a, **k: pa.paged_attention_stats(*a, max_length=None, **k)):
        pools, _ = _pools(dtype, hkv, d, seed=1)
        outs.append(call(q, pools, lengths, base, write, **kw))
    for other in outs[1:]:
        for a, b in zip(outs[0][:3], other[:3]):
            assert torch.equal(a, b)
        for a, b in zip(outs[0][3], other[3]):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_decode_paged_active_matches_jax(quantized):
    """``decode_paged`` with ragged ``index`` and an ``active`` mask over
    pools holding a prefilled history, f32 weights, in both packages."""
    jcfg, cfg, params, model, _ = tiny_models(seed=5)
    net = cfg.net
    b, pps = 4, 2
    rng = np.random.default_rng(6)
    emb = torch.from_numpy(rng.normal(size=(b, 40, net.hidden_size)).astype(np.float32))
    pools = pa.alloc_pools(net.kv_heads, net.num_layers * b * pps, PS, net.head_dim,
                           torch.float32, torch.device("cpu"), quantized=quantized)
    _, pools = model.net.prefill_paged(emb, pools, page_size=PS, pages_per_slot=pps)
    # copies: the port appends in place, the JAX arrays must stay as they are
    jpools = jpa.PagedPools(*(None if t is None else jnp.asarray(
        t.float().numpy().copy(), {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16}.get(
            t.dtype, jnp.float32)) for t in pools))
    index = np.array([40, 3, 2 * PS * pps, 17], np.int32)  # slot 2 at capacity
    active = np.array([True, False, True, True])
    x = rng.normal(size=(b, net.hidden_size)).astype(np.float32)
    kw = dict(page_size=PS, pages_per_slot=pps)
    h, out = model.net.decode_paged(torch.from_numpy(x), pools, torch.from_numpy(index),
                                    torch.from_numpy(active), **kw)
    jh, jout = jllama.decode_paged(params["net"], jcfg.net, jnp.asarray(x), jpools,
                                   jnp.asarray(index), jnp.asarray(active), **kw)
    np.testing.assert_allclose(h[active].numpy(), np.asarray(jh)[active], atol=1e-4, rtol=1e-4)
    for ours, theirs in zip(out, jout):
        if ours is None:
            continue
        diff = np.abs(ours.float().numpy() - np.asarray(theirs, np.float32))
        np.testing.assert_array_less(diff, 1.0 + 1e-6 if ours.dtype == torch.int8 else 1e-3)


def test_decode_paged_int_index_equals_tensor():
    """One int length (``generate``'s uniform slots) gives what the same
    length per slot gives, appends included."""
    _, cfg, _, model, _ = tiny_models(seed=5)
    net = cfg.net
    b, pps = 3, 2
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(rng.normal(size=(b, 20, net.hidden_size)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, net.hidden_size)).astype(np.float32))
    outs = []
    for index in (20, torch.full((b,), 20, dtype=torch.int32)):
        pools = pa.alloc_pools(net.kv_heads, net.num_layers * b * pps, PS, net.head_dim,
                               torch.float32, torch.device("cpu"))
        _, pools = model.net.prefill_paged(emb, pools, page_size=PS, pages_per_slot=pps)
        outs.append(model.net.decode_paged(x, pools, index, page_size=PS,
                                           pages_per_slot=pps))
    (h_int, p_int), (h_t, p_t) = outs
    assert torch.equal(h_int, h_t)
    assert torch.equal(p_int.k, p_t.k) and torch.equal(p_int.v, p_t.v)
