"""The port's model modules agree with the JAX package's functions on the same
fp32 weights: weight loading, the event and token nets, the dense token
cache, and prefill_paged + decode_paged (hidden states and pools).

Tolerance: atol 1e-5 — fp32 on both sides, only summation order differs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.interop import state_dict_from_params as jax_sd_from_params
from midi_model_tpu.interop import synthesize_state_dict as jax_synthesize
from midi_model_tpu.models import llama as jllama
from midi_model_tpu.models import midinet as jmidinet
from midi_model_tpu.ops import paged_allheads as jpa
from midi_model_tpu_torch.interop import (from_jax_params, state_dict_from_params,
                                          synthesize_state_dict)
from midi_model_tpu_torch.models.llama import DenseCache
from midi_model_tpu_torch.ops import paged_allheads as pa

from _torch_helpers import layout, one_torch_thread, tiny_models, to_np  # noqa: F401

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=11)


def test_weights_two_ways_agree(models):
    jcfg, cfg, params, model, sd = models
    via_jax = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    a, b = model.state_dict(), via_jax.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    back = state_dict_from_params(model)
    jback = jax_sd_from_params(params, jcfg)
    assert back.keys() == jback.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])
        np.testing.assert_array_equal(back[k], jback[k])


def test_synthesize_matches_jax(models):
    cfg = models[1]
    lay = layout(cfg)
    ours, ref = synthesize_state_dict(lay, 5), jax_synthesize(lay, 5)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_bf16_load_rounds_like_jax(models):
    jcfg, cfg, params, _, sd = models
    from midi_model_tpu_torch.interop import params_from_state_dict

    model = params_from_state_dict(sd, cfg, dtype=torch.bfloat16, device="cpu")
    ours = model.net.layers[0].self_attn.q_proj.weight.float().numpy()
    ref = np.asarray(jnp.asarray(sd["net.layers.0.self_attn.q_proj.weight"],
                                 jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(ours, ref)


def test_forward_and_forward_token_match_jax(models):
    jcfg, cfg, params, model, _ = models
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.tokenizer.vocab_size, (2, 19, 8))
    hidden, cache = model(torch.from_numpy(x))
    assert cache is None
    jhidden, _ = jmidinet.forward(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(to_np(hidden), np.asarray(jhidden), atol=ATOL)

    y = rng.integers(0, cfg.tokenizer.vocab_size, (2, 7))
    logits, _ = model.forward_token(hidden[:, -1], torch.from_numpy(y))
    jlogits, _ = jmidinet.forward_token(params, jcfg, jhidden[:, -1], jnp.asarray(y))
    assert logits.dtype == torch.float32 and logits.shape == (2, 8, cfg.tokenizer.vocab_size)
    np.testing.assert_allclose(to_np(logits), np.asarray(jlogits), atol=ATOL)


def test_token_net_dense_cache_matches_jax(models):
    """Incremental token-net decode over the 8-position cache == JAX's."""
    jcfg, cfg, params, model, _ = models
    rng = np.random.default_rng(1)
    b, t = 3, cfg.tokenizer.max_token_seq
    hidden = rng.normal(size=(b, cfg.n_embd)).astype(np.float32)
    toks = rng.integers(0, cfg.tokenizer.vocab_size, (b, t))
    cache = DenseCache.zeros(cfg.net_token, b, t, torch.float32, torch.device("cpu"))
    jcache = jllama.KVCache.zeros(jcfg.net_token, b, t)
    for i in range(t):
        if i == 0:
            logits, cache = model.forward_token(torch.from_numpy(hidden), None, cache)
            jlogits, jcache = jmidinet.forward_token(params, jcfg, jnp.asarray(hidden),
                                                     None, jcache)
        else:
            prev = toks[:, i - 1:i]
            logits, cache = model.forward_token(None, torch.from_numpy(prev), cache)
            jlogits, jcache = jmidinet.forward_token(params, jcfg, None,
                                                     jnp.asarray(prev), jcache)
        np.testing.assert_allclose(to_np(logits), np.asarray(jlogits), atol=ATOL)
    assert cache.index == t


def test_prefill_and_decode_paged_match_jax(models):
    """A 30-row prompt over 8-row pages (crossing page boundaries), then
    decode steps up to and past capacity (write clipped to the last row)."""
    jcfg, cfg, params, model, _ = models
    net, jnet = cfg.net, jcfg.net
    rng = np.random.default_rng(2)
    b, p_len, ps, pps = 2, 30, 8, 4
    cap = ps * pps
    n_pages = net.num_layers * b * pps
    prompt = rng.integers(0, cfg.tokenizer.vocab_size, (b, p_len, 8))
    emb = model.embed_events(torch.from_numpy(prompt))
    jemb = jmidinet.embed_events(params, jnp.asarray(prompt))
    np.testing.assert_allclose(to_np(emb), np.asarray(jemb), atol=ATOL)

    pools = pa.alloc_pools(net.kv_heads, n_pages, ps, net.head_dim,
                           torch.float32, torch.device("cpu"))
    jpools = jpa.alloc_pools(jnet.kv_heads, n_pages, ps, jnet.head_dim, jnp.float32)
    hidden, pools = model.net.prefill_paged(emb, pools, page_size=ps, pages_per_slot=pps)
    jhidden, jpools = jllama.prefill_paged(params["net"], jnet, jemb, jpools,
                                           page_size=ps, pages_per_slot=pps)
    np.testing.assert_allclose(to_np(hidden), np.asarray(jhidden), atol=ATOL)
    np.testing.assert_allclose(to_np(pools.k), np.asarray(jpools.k), atol=ATOL)
    np.testing.assert_allclose(to_np(pools.v), np.asarray(jpools.v), atol=ATOL)

    for step in range(4):  # index 30, 31, 32 (= capacity), 33
        index = np.full((b,), p_len + step, np.int32)
        index[1] = min(index[1], 31)  # a ragged slot
        x = rng.normal(size=(b, net.hidden_size)).astype(np.float32) * 0.1
        h, pools = model.net.decode_paged(torch.from_numpy(x), pools,
                                          torch.from_numpy(index), page_size=ps,
                                          pages_per_slot=pps)
        jh, jpools = jllama.decode_paged(params["net"], jnet, jnp.asarray(x), jpools,
                                         jnp.asarray(index), page_size=ps,
                                         pages_per_slot=pps, streaming=False)
        np.testing.assert_allclose(to_np(h), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(to_np(pools.k), np.asarray(jpools.k), atol=ATOL)
        np.testing.assert_allclose(to_np(pools.v), np.asarray(jpools.v), atol=ATOL)
    assert index[0] > cap


def test_prefill_pool_size_checked(models):
    cfg, model = models[1], models[3]
    net = cfg.net
    pools = pa.alloc_pools(net.kv_heads, 3, 8, net.head_dim, torch.float32,
                           torch.device("cpu"))
    with pytest.raises(ValueError):
        model.net.prefill_paged(torch.zeros((2, 4, net.hidden_size)), pools,
                                page_size=8, pages_per_slot=4)
