"""The port's plain attention agrees with the JAX package's ``xla_attention``
under the causal bias and under a cache bias.

Tolerances: f32 atol 1e-5 (summation order only).  bf16: both sides score
in f32 from the same bf16 values and round the probabilities to bf16 before
P.V; outputs may still differ where an f32 sum rounds to a neighbouring bf16
value, so atol 2e-2 (a bf16 step at magnitude 2-4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midi_model_tpu.ops.attention import xla_attention
from midi_model_tpu_torch.ops import attention as at
from midi_model_tpu_torch.ops.attention import (attention_reference,
                                                causal_attention, causal_bias)

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse; also sets full fp32)

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _qkv(b, s, h, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, s, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, s, hkv, dh)).astype(np.float32))


def _jax(x, dtype):
    return jnp.asarray(x, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,hkv,dh", [(2, 37, 4, 4, 16), (1, 130, 8, 2, 32),
                                          (2, 64, 16, 16, 64),
                                          # the token net: many 8-row sequences, Dh 256
                                          (96, 8, 4, 4, 256),
                                          # the event net's training length (a ragged
                                          # last tile), small B and H
                                          (1, 2047, 2, 2, 64)])
def test_causal_attention_matches_xla(b, s, h, hkv, dh, dtype):
    q, k, v = _qkv(b, s, h, hkv, dh, seed=s)
    pos = np.arange(s)
    bias = np.where(pos[None, :] <= pos[:, None], 0.0, -np.inf).astype(np.float32)
    ref = xla_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                        jnp.asarray(bias)[None, None])
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    ours = causal_attention(tq, tk, tv)
    assert ours.dtype == dtype and ours.shape == (b, s, h, dh)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               **TOL[dtype])
    np.testing.assert_array_equal(
        ours.float().numpy(),
        attention_reference(tq, tk, tv, causal_bias(s, tq.device)).float().numpy())


def test_strided_inputs():
    """q sliced out of a wider tensor (no copy) gives the same result."""
    rng = np.random.default_rng(0)
    wide = torch.from_numpy(rng.normal(size=(2, 20, 4, 64)).astype(np.float32))
    q = wide[..., :32]
    k = torch.from_numpy(rng.normal(size=(2, 20, 4, 32)).astype(np.float32))
    assert not q.is_contiguous()
    np.testing.assert_allclose(causal_attention(q, k, k).numpy(),
                               causal_attention(q.contiguous(), k, k).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cache_bias_matches_xla(dtype):
    """A query block at positions 3..4 over an 8-row cache (the token net)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 2, 2, 16)).astype(np.float32)
    k = rng.normal(size=(3, 8, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 8, 2, 16)).astype(np.float32)
    pos = np.arange(3, 5)
    bias = np.where(np.arange(8)[None, :] <= pos[:, None], 0.0,
                    -np.inf).astype(np.float32)[None, None]
    ref = xla_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                        jnp.asarray(bias))
    ours = attention_reference(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                               torch.from_numpy(bias))
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               **TOL[dtype])


def test_vector_operands():
    """The kernels read 16 bytes at a time (8 bf16, 4 f32 elements): the
    wrapper passes the model's layouts (contiguous, or q, k, v as views of a
    wider projection) as they lie, and copies an input with a misaligned
    base, a stride that is not a multiple of 16 bytes, or heads laid out
    outside positions."""
    wide = torch.zeros(2, 5, 4, 128, dtype=torch.bfloat16)
    contiguous = torch.zeros(2, 5, 4, 64, dtype=torch.bfloat16)
    for x in (contiguous, wide[..., :64], wide[..., 64:]):
        assert at._vector_ready(x) and at._vector_operand(x) is x
    heads_outside = torch.zeros(2, 4, 5, 64, dtype=torch.bfloat16).transpose(1, 2)
    odd_stride = torch.zeros(2, 5, 4, 68, dtype=torch.bfloat16)[..., :64]
    misaligned = wide[..., 4:68]
    for x in (heads_outside, odd_stride, misaligned):
        assert not at._vector_ready(x)
        y = at._vector_operand(x)
        assert y.is_contiguous() and at._vector_ready(y) and torch.equal(y, x)
    # f32: 16 bytes are 4 elements, so a row pitch of 68 is read in place
    # (the bf16 one above is not), 66 is not, nor a base 8 bytes off
    wide32 = torch.zeros(2, 5, 4, 512)
    pitch68 = torch.zeros(2, 5, 4, 68)[..., :64]
    for x in (torch.zeros(2, 5, 4, 64), wide32[..., :256], wide32[..., 256:], pitch68,
              torch.zeros(4094, 8, 4, 256)):
        assert at._vector_ready(x) and at._vector_operand(x) is x
    for x in (torch.zeros(2, 4, 5, 64).transpose(1, 2), torch.zeros(2, 5, 4, 66)[..., :64],
              wide32[..., 2:66]):
        assert not at._vector_ready(x)
        y = at._vector_operand(x)
        assert y.is_contiguous() and at._vector_ready(y) and torch.equal(y, x)


def test_kernel_strides_of_unit_axes():
    """A size-1 axis's stride is never applied; the kernels get the stride it
    would have over the axes inside it (a tensor map wants a whole step)."""
    x = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    assert at._kernel_strides(x) == (64, 64, 64)
    y = torch.zeros(3, 7, 2, 64, dtype=torch.bfloat16)[:1, :, :1]
    assert at._kernel_strides(y) == (7 * 128, 128, 64)
    assert at._vector_ready(y)
    z = torch.zeros(2, 9, 4, 256)
    assert at._kernel_strides(z) == z.stride()[:3]
