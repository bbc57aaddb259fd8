"""The port's plain top-p/top-k sampler gives the same ids as the JAX
package's Pallas sampler kernel (interpret mode) on the same noise.

The noise is rebuilt exactly as ``sample_top_p_k_tpu`` draws it
(``ops/sampler.py:99-103``): ``jax.random.gumbel(key, (B, k_cap))`` for one
key, and the vmapped per-row form for ``[B, 2]`` keys.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.ops.sampler import sample_top_p_k_tpu
from midi_model_tpu_torch.ops.sampler import sample_top_p_k_reference
from midi_model_tpu_torch.sampling import K_CAP, sample_greedy, sample_top_p_k

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse; also sets full fp32)

B, V = 6, 300


def _probs(kind: str, rng) -> np.ndarray:
    if kind == "peaked":
        logits = rng.normal(size=(B, V)) * 6.0
    elif kind == "flat":
        logits = np.zeros((B, V))
    elif kind == "ties":
        logits = np.round(rng.normal(size=(B, V)) * 2.0)
    else:  # masked: grammar-style zeros, mass < 1
        logits = rng.normal(size=(B, V))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "masked":
        p = p * (rng.random((B, V)) < 0.1)
        p[-1] = 0.0  # a row with no mass at all returns index 0
    return p.astype(np.float32)


def _noise(key, per_row: bool):
    if per_row:
        keys = jax.random.split(key, B)
        return keys, jax.vmap(
            lambda k: jax.random.gumbel(k, (K_CAP,), jnp.float32))(keys)
    return key, jax.random.gumbel(key, (B, K_CAP), jnp.float32)


KNOBS = {
    "default": (0.98, 20),
    "top_k_1": (0.9, 1),
    "top_p_1": (1.0, 40),
    "per_row": (np.array([0.98, 0.5, 1.0, 0.1, 0.9, 0.7], np.float32),
                np.array([20, 1, 40, 5, 0, 33], np.int32)),
}


@pytest.mark.parametrize("per_row_key", [False, True])
@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("kind", ["peaked", "flat", "ties", "masked"])
def test_ids_equal_pallas_kernel(kind, knobs, per_row_key):
    rng = np.random.default_rng(hash((kind, knobs)) % 2**32)
    probs = _probs(kind, rng)
    top_p, top_k = KNOBS[knobs]
    for trial in range(3):
        key, g = _noise(jax.random.PRNGKey(trial), per_row_key)
        ref = sample_top_p_k_tpu(jnp.asarray(probs), top_p, top_k, key,
                                 k_cap=K_CAP, interpret=True)
        ours = sample_top_p_k(torch.from_numpy(probs), top_p, top_k,
                              torch.from_numpy(np.asarray(g)))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_reference_keeps_only_the_kept_set():
    """Every drawn id lies in the reference keep set (stable descending
    sort, exclusive cumsum <= top_p, rank < top_k)."""
    rng = np.random.default_rng(3)
    probs = _probs("masked", rng)[:-1]
    b = probs.shape[0]
    top_p, top_k = 0.6, 7
    gen = torch.Generator().manual_seed(0)
    seen = [set() for _ in range(b)]
    for _ in range(200):
        g = -torch.log(torch.empty((b, K_CAP)).exponential_(generator=gen))
        ids = sample_top_p_k_reference(
            torch.from_numpy(probs), torch.full((b,), top_p),
            torch.full((b,), top_k, dtype=torch.int32), g)
        for r, i in enumerate(ids.tolist()):
            seen[r].add(i)
    for r in range(b):
        order = np.argsort(-probs[r], kind="stable")
        sp = probs[r][order]
        keep = ((np.cumsum(sp) - sp) <= top_p) & (np.arange(V) < top_k)
        assert seen[r] <= set(order[keep].tolist())


def test_greedy_takes_first_maximum():
    probs = torch.tensor([[0.1, 0.4, 0.4, 0.1], [0.0, 0.0, 0.0, 0.0]])
    assert sample_greedy(probs).tolist() == [1, 0]
    assert sample_greedy(probs).dtype == torch.int32
