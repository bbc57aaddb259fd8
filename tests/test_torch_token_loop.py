"""The port's token row (``ops.token_loop``, its plain version on the CPU)
equals the JAX package's Pallas token-row kernel in interpret mode, row for
row, with f32 weights and shared noise.

The noise is built exactly as the JAX wrapper builds it
(``token_loop.py:320``): ``jax.random.gumbel(key, (t_max*B, 128))``, the
step-major layout ``gumbel_rows`` draws in the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.ops import token_loop as jtl
from midi_model_tpu_torch.ops import token_loop as tl
from midi_model_tpu_torch.sampling import (K_CAP, build_allow_vector,
                                           build_mask_table, mask_tensors)

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)

B = 4


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, params, model, _ = tiny_models(seed=7)
    table = build_mask_table(cfg.tokenizer)
    jmasks = tuple(jnp.asarray(m) for m in (table.first, table.steps, table.pad_only))
    hidden = (np.random.default_rng(1).normal(size=(B, cfg.n_embd)) * 0.5
              ).astype(np.float32)
    return jcfg, cfg, params, model, jmasks, mask_tensors(table, "cpu"), hidden


def _allow(tok):
    allow = np.ones((B, tok.vocab_size), bool)
    allow[0] = build_allow_vector(tok, disable_patch_change=True, disable_channels=[1, 3])
    allow[2] = build_allow_vector(tok, disable_control_change=True)
    return allow


CASES = {
    "greedy": dict(greedy=True, knobs=(1.0, 0.98, 20)),
    "sampled": dict(greedy=False, knobs=(1.0, 0.98, 20)),
    "top_k_1": dict(greedy=False, knobs=(1.0, 1.0, 1)),
    "per_row": dict(greedy=False, knobs=([1.0, 0.8, 1.2, 1.0], [0.98, 0.9, 1.0, 0.5],
                                         [20, 8, 1, 64])),
    "forced_pad": dict(greedy=False, knobs=(1.0, 0.98, 20),
                       forced=[True, False, False, True]),
    "allow": dict(greedy=False, knobs=(1.0, 0.98, 20), allow=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_token_row_equals_pallas_kernel(case, setup):
    jcfg, cfg, params, model, jmasks, masks, hidden = setup
    spec = CASES[case]
    t_max = cfg.tokenizer.max_token_seq
    key = jax.random.PRNGKey(len(case))
    gumbel = np.array(jax.random.gumbel(key, (t_max * B, K_CAP), jnp.float32))
    temp, top_p, top_k = spec["knobs"]
    forced = spec.get("forced")
    allow = _allow(cfg.tokenizer) if spec.get("allow") else None

    def jax_knob(x, dt):
        return jnp.asarray(x, dt) if isinstance(x, list) else x

    ref_row, ref_ended = jtl.decode_token_row(
        params, jcfg, jnp.asarray(hidden), jmasks, jax_knob(temp, jnp.float32),
        jax_knob(top_p, jnp.float32), jax_knob(top_k, jnp.int32), key,
        greedy=spec["greedy"],
        forced_pad=None if forced is None else jnp.asarray(forced),
        allow=None if allow is None else jnp.asarray(allow, jnp.float32),
        interpret=True)

    def knob(x, dt):
        return torch.tensor(x, dtype=dt) if isinstance(x, list) else x

    row, ended = tl.decode_token_row(
        model, cfg, torch.from_numpy(hidden), masks, knob(temp, torch.float32),
        knob(top_p, torch.float32), knob(top_k, torch.int32),
        torch.from_numpy(gumbel), greedy=spec["greedy"],
        forced_pad=None if forced is None else torch.tensor(forced),
        allow=None if allow is None else torch.from_numpy(allow))
    assert row.dtype == torch.int32 and ended.dtype == torch.bool
    np.testing.assert_array_equal(row.numpy(), np.asarray(ref_row))
    np.testing.assert_array_equal(ended.numpy(), np.asarray(ref_ended))
    if forced is not None:
        assert (row.numpy()[np.asarray(forced)] == cfg.tokenizer.pad_id).all()


def test_split_path_row_equals_plain_version(setup):
    """The split path's token row (the plain version drawing through the
    sampler's dispatcher) is the plain version on CPU tensors."""
    from midi_model_tpu_torch.sampling import gumbel_rows, sample_top_p_k

    _, cfg, _, model, _, masks, hidden = setup
    gen = torch.Generator().manual_seed(3)
    gumbel = gumbel_rows(B, cfg.tokenizer.max_token_seq, gen)
    assert gumbel.shape == (cfg.tokenizer.max_token_seq * B, K_CAP)
    h = torch.from_numpy(hidden)
    args = (model, cfg, h, masks, 1.0, 0.98, 20, gumbel)
    ours = tl.decode_token_row_reference(*args, greedy=False, sample=sample_top_p_k)
    ref = tl.decode_token_row_reference(*args, greedy=False)
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)
