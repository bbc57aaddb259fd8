"""The port's causal attention gradients on the CPU — the autograd
function's backward, i.e. ``causal_attention_backward_reference``, the
formulas the CUDA backward kernel implements — against ``jax.grad`` of the
JAX package's ``xla_attention`` and of its ``splash_causal_attention`` (the
training kernel, in Pallas interpret mode as ``tests/test_attention.py``
runs it), at odd lengths (the ragged last tile), head_dim 64 (the event
net) and 256 (the token net), and one GQA case.

Tolerance: f32 atol and rtol 1e-5 (summation order only; measured up to
2.4e-6).

bf16 (the training dtype): the plain backward on bf16 tensors against
``jax.grad`` of ``xla_attention`` on the same bf16 values, atol and rtol
2e-2.  Both score in f32 and round P to bf16 before P.V; JAX's autodiff
also rounds the cotangent of the bf16 probabilities (dP) and each einsum's
output to bf16, the plain version keeps dP and dS in f32 and rounds only the
gradients.  Measured: dv within one bf16 step (up to 0.0156 at magnitude
8), dq and dk up to 0.0234 at magnitude 3.5 (one to two bf16 steps); the
largest |d| - 0.02 |ref| is 0.0136, inside the 0.02 atol."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu_torch.ops import attention as at

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse; also sets full fp32)

jattn = importlib.import_module("midi_model_tpu.ops.attention")
TOL = dict(atol=1e-5, rtol=1e-5)

# (B, S, H, Hkv, Dh)
CASES = [(1, 8, 2, 2, 64), (2, 67, 4, 4, 64), (1, 520, 2, 2, 64),
         (1, 67, 2, 2, 256), (1, 520, 1, 1, 256), (2, 67, 4, 2, 64)]


@pytest.fixture(autouse=True)
def _interpret_splash(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)


def _inputs(b, s, h, hkv, dh):
    rng = np.random.default_rng(s + dh + hkv)
    q, k, v = (rng.normal(size=(b, s, n, dh)).astype(np.float32) for n in (h, hkv, hkv))
    return q, k, v, rng.normal(size=(b, s, h, dh)).astype(np.float32)


def _port_grads(q, k, v, w):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (at.causal_attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("backend", ["xla", "splash"])
@pytest.mark.parametrize("b,s,h,hkv,dh", CASES)
def test_grads_match_jax(b, s, h, hkv, dh, backend):
    q, k, v, w = _inputs(b, s, h, hkv, dh)
    bias = jnp.asarray(at.causal_bias(s, torch.device("cpu")).numpy())
    fn = {"xla": lambda q, k, v: jattn.xla_attention(q, k, v, bias),
          "splash": jattn.splash_causal_attention}[backend]
    ref = jax.grad(lambda q, k, v: (fn(q, k, v) * w).sum(), argnums=(0, 1, 2))(q, k, v)
    for name, ours, want in zip("qkv", _port_grads(q, k, v, w), ref):
        assert ours.shape == want.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("b,s,h,hkv,dh", CASES + [(64, 8, 4, 4, 256)])
def test_bf16_grads_match_jax(b, s, h, hkv, dh):
    """The training dtype: bf16 inputs on both sides, the token net's many
    8-row sequences among the cases."""
    q, k, v, w = _inputs(b, s, h, hkv, dh)
    bias = jnp.asarray(at.causal_bias(s, torch.device("cpu")).numpy())
    ref = jax.grad(lambda q, k, v: (jattn.xla_attention(q, k, v, bias).astype(jnp.float32)
                                    * w).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    (at.causal_attention(tq, tk, tv).float() * torch.from_numpy(w)).sum().backward()
    for name, ours, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        assert ours.dtype == torch.bfloat16 and ours.shape == want.shape
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=f"d{name}")


def test_backward_is_the_plain_version_from_the_lse():
    """On CPU tensors the autograd backward is exactly
    ``causal_attention_backward_reference``, and the forward's log-sum-exp
    is each row's ``logsumexp`` of its scaled causal scores."""
    q, k, v, w = _inputs(2, 37, 4, 2, 64)
    grads = _port_grads(q, k, v, w)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = at._forward(tq, tk, tv, with_lse=True)
    s = tq.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", tq, tk.repeat_interleave(2, dim=2)) * 64 ** -0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(
        scores + at.causal_bias(s, tq.device), dim=-1).numpy(), atol=1e-6)
    ref = at.causal_attention_backward_reference(tq, tk, tv, out, torch.from_numpy(w), lse)
    for ours, want in zip(grads, ref):
        assert torch.equal(ours, want)


def test_no_autograd_record_without_grad():
    """Prefill (``no_grad``, or inputs that need no gradient) takes the
    forward alone; bf16 gradients come back in bf16."""
    q = torch.randn(1, 5, 2, 64)
    assert at.causal_attention(q, q, q).grad_fn is None
    qb = q.to(torch.bfloat16).requires_grad_(True)
    out = at.causal_attention(qb, qb, qb)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert qb.grad.dtype == torch.bfloat16 and bool(torch.isfinite(qb.grad.float()).all())
    with torch.no_grad():
        assert at.causal_attention(qb, qb, qb).grad_fn is None
