"""The port's paged pools and plain paged decode with append agree with the
JAX package: its Pallas per-slot kernel (interpret mode) and ``_decode_xla``.

Tolerances: against ``_decode_xla`` (both f32 over the same values) atol
1e-5; against the Pallas kernel 3e-2, because that kernel feeds q to the
matrix unit in bf16 (``build_q_diag``) — the same bound the JAX package's
own test holds it to."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midi_model_tpu.ops import paged_allheads as jpa
from midi_model_tpu_torch.ops import paged_allheads as pa

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse; also sets full fp32)

PS, PPS = 16, 6
CAP = PS * PPS


def _setup(h, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    b, n_pages = 5, 34
    raw = rng.normal(size=(2, n_pages, PS, hkv, d)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jk = jpa.pack_heads(jnp.asarray(raw[0], jdtype), hkv, d)
    jv = jpa.pack_heads(jnp.asarray(raw[1], jdtype), hkv, d)
    # copies: the port appends in place, the JAX arrays must stay as they are
    pools = pa.PagedPools(torch.tensor(np.asarray(jk, np.float32)).to(dtype),
                          torch.tensor(np.asarray(jv, np.float32)).to(dtype))
    q = (rng.normal(size=(b, h, d)) * d ** -0.5).astype(np.float32)
    # empty, mid-page, page edge, one row, and a full slot whose clipped
    # write lands on a row this call reads
    lengths = np.array([37, 0, CAP, 1, 64], np.int32)
    base = np.array([0, 6, 12, 18, 24], np.int32)
    new = rng.normal(size=(2, b, hkv, d)).astype(np.float32)
    write_pos = np.clip(lengths, 0, CAP - 1)
    wpages = (base + write_pos // PS).astype(np.int32)
    woffs = (write_pos % PS).astype(np.int32)
    return pools, (jk, jv), q, lengths, base, new, wpages, woffs


CASES = [(8, 4, 64), (4, 4, 64), (4, 1, 16)]  # GQA, MHA, padded head stride


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,hkv,d", CASES)
def test_paged_stats_and_append_match_jax(h, hkv, d, dtype):
    pools, (jk, jv), q, lengths, base, new, wpages, woffs = _setup(h, hkv, d, dtype, 1)
    jdtype = jk.dtype
    jnew_k = jpa.pack_heads(jnp.asarray(new[0], jdtype), hkv, d)
    jnew_v = jpa.pack_heads(jnp.asarray(new[1], jdtype), hkv, d)
    new_k = pa.pack_heads(torch.from_numpy(new[0]).to(dtype), hkv, d)
    new_v = pa.pack_heads(torch.from_numpy(new[1]).to(dtype), hkv, d)
    kw = dict(page_size=PS, pages_per_slot=PPS, kv_heads=hkv, head_dim=d)

    o, m, l, out = pa.paged_attention_stats(
        torch.from_numpy(q), pools, torch.from_numpy(lengths),
        torch.from_numpy(base),
        (new_k, new_v, None, torch.from_numpy(wpages), torch.from_numpy(woffs)), **kw)
    assert out.k is pools.k  # updated in place

    jpools = jpa.PagedPools(k=jk, v=jv)
    jargs = (jnp.asarray(q), jpools, jnp.asarray(lengths), jnp.asarray(base))
    o_x, m_x, l_x = jpa._decode_xla(*jargs, **kw)
    o_k, m_k, l_k, jout = jpa.paged_attention_stats(
        *jargs, (jnew_k, jnew_v, None, jnp.asarray(wpages), jnp.asarray(woffs)),
        ppcb=2, streaming=False, interpret=True, **kw)
    ref_pools = jpa.kv_append(jpools, jnew_k, jnew_v, jnp.asarray(wpages),
                              jnp.asarray(woffs))

    # pools after the append equal both JAX paths, bit for bit
    for ours, a, b in ((out.k, ref_pools.k, jout.k), (out.v, ref_pools.v, jout.v)):
        ours = ours.float().numpy()
        np.testing.assert_array_equal(ours, np.asarray(a, np.float32))
        np.testing.assert_array_equal(ours, np.asarray(b, np.float32))

    live = lengths > 0
    o, m, l = o.numpy(), m.numpy(), l.numpy()
    np.testing.assert_allclose(o, np.asarray(o_x), atol=1e-5)
    np.testing.assert_allclose(m[live], np.asarray(m_x)[live], atol=1e-5)
    np.testing.assert_allclose(l, np.asarray(l_x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o[live], np.asarray(o_k)[live], atol=3e-2)
    np.testing.assert_allclose(m[live], np.asarray(m_k)[live], atol=3e-2)
    np.testing.assert_allclose(l[live], np.asarray(l_k)[live], rtol=2e-2)
    # an empty slot: m = -inf, l = 0, o = 0, never NaN
    assert np.all(m[~live] == -np.inf) and np.all(l[~live] == 0)
    assert np.all(o[~live] == 0)


@pytest.mark.parametrize("h,hkv,d", CASES)
def test_pool_helpers_match_jax(h, hkv, d):
    assert pa.head_stride(d, hkv) == jpa.head_stride(d, hkv)
    x = np.random.default_rng(0).normal(size=(3, hkv, d)).astype(np.float32)
    np.testing.assert_array_equal(
        pa.pack_heads(torch.from_numpy(x), hkv, d).numpy(),
        np.asarray(jpa.pack_heads(jnp.asarray(x), hkv, d)))
    pools = pa.alloc_pools(hkv, 7, PS, d, torch.bfloat16, torch.device("cpu"))
    jpools = jpa.alloc_pools(hkv, 7, PS, d, jnp.bfloat16)
    assert tuple(pools.k.shape) == jpools.k.shape and pools.page_size == PS
    assert pools.k.dtype == torch.bfloat16 and not pools.k.any()


def test_int8_pools_not_ported():
    """int8 pools are ported for the paged decode kernels and for the
    whole-step kernel's int8 form, which reads the pools and appends each
    active slot's quantized row with its scale row."""
    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.ops import fused_step as fs

    pools = pa.alloc_pools(4, 8, PS, 64, torch.float32, torch.device("cpu"),
                           quantized=True)
    assert pools.quantized and pools.k.dtype == torch.int8
    cfg = MIDIModelConfig.get_config("v2", True, n_layer=1, n_head=4, n_embd=512,
                                     n_inner=256)
    model = init_model(cfg, device="cpu")
    pools = pa.alloc_pools(4, 2 * 4, PS, 128, torch.float32, torch.device("cpu"),
                           quantized=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 512)).astype(np.float32))
    h, out = fs.fused_decode_step(fs.prepare_fused(model.net), cfg.net, x, pools,
                                  torch.tensor([3, 0], dtype=torch.int32),
                                  torch.tensor([True, False]), page_size=PS,
                                  pages_per_slot=4)
    assert h.shape == (2, 512) and bool(torch.isfinite(h).all())
    # slot 0 appended at row 3 of its first page; slot 1 (inactive) nothing
    assert out.k[0, 3].any() and out.scales[0, 3, :8].all()
    assert not out.k[4:].any() and not out.scales[4:].any()
