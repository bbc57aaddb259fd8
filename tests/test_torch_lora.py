"""The port's LoRA (``midi_model_tpu_torch.models.lora``) and its train step
on the CPU, mirroring ``tests/test_lora.py`` case for case, and held to the
JAX package's on one tiny model's weights:

- ``apply_lora`` equals JAX's within 1e-6 on an adapter made by JAX's
  ``init_lora`` and carried over by peft's layout;
- one f32 LoRA step with accumulation 2 against JAX's
  ``make_lora_train_step`` (optax against the port's ``Optimizer``): the
  loss within 1e-5, the factors' gradients and the updated factors within
  1e-5 of each leaf's largest value; B starts at 0.01 (with B = 0, A's
  gradient is exactly zero); the base weights bit-identical after the step,
  and weight decay on every factor, as JAX's ``ndim >= 2`` mask over its
  stacked factors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.models import lora as jlora
from midi_model_tpu.models import midinet as jmidinet
from midi_model_tpu.train import trainer as jtr
from midi_model_tpu_torch.interop import to_jax_tree
from midi_model_tpu_torch.models.lora import (DEFAULT_TARGETS, _PEFT_NAMES, apply_lora,
                                              init_lora, lora_to_peft_state_dict, merge_lora,
                                              peft_state_dict_to_lora)
from midi_model_tpu_torch.train import init_train_state, loss_fn, make_optimizer
from midi_model_tpu_torch.train import trainer as tr

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)

RANK, ALPHA = 4, 8.0


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, jparams, model, _ = tiny_models(seed=0)
    return jcfg, cfg, jparams, model, {n: p.detach() for n, p in model.named_parameters()}


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def _weight(module, target, layer=0, net="net"):
    return f"{net}.layers.{layer}.{_PEFT_NAMES[target]}.{module}"


def test_zero_init_is_identity(setup):
    params = setup[4]
    lora = init_lora(params, _gen(1), rank=RANK)
    assert len(lora) == 2 * len(DEFAULT_TARGETS) * 5  # 4 event + 1 token layers
    merged = apply_lora(params, lora)
    for name, w in params.items():
        torch.testing.assert_close(merged[name], w, rtol=0, atol=1e-6)


def test_apply_changes_weights(setup):
    params = setup[4]
    lora = init_lora(params, _gen(1), rank=RANK)
    b_key = _weight("lora_B.weight", "wq")
    lora[b_key] = torch.full_like(lora[b_key], 0.01)  # poke B so the delta is nonzero
    merged = apply_lora(params, lora, alpha=ALPHA)
    name = _weight("weight", "wq")
    w0, w1 = params[name].numpy(), merged[name].numpy()
    assert np.abs(w1 - w0).max() > 1e-5
    # the delta is (alpha/r)·B@A in torch's [out, in] layout
    a, b = lora[_weight("lora_A.weight", "wq")].numpy(), lora[b_key].numpy()
    np.testing.assert_allclose(w1 - w0, (b @ a) * (ALPHA / RANK), atol=1e-5)
    # everything but the adapted matrices is the base's own tensor
    assert merged["net.embed_tokens.weight"] is params["net.embed_tokens.weight"]
    torch.testing.assert_close(merged[_weight("weight", "wq", layer=1)],
                               params[_weight("weight", "wq", layer=1)], rtol=0, atol=0)


def test_peft_roundtrip(setup):
    cfg, params = setup[1], setup[4]
    lora = init_lora(params, _gen(2), rank=RANK)
    for key in lora:
        if key.startswith("net_token.") and ".down_proj.lora_B" in key:
            lora[key] = torch.full_like(lora[key], 0.5)
    sd = lora_to_peft_state_dict(lora)
    assert all(k.startswith("base_model.model.") for k in sd) and any("lora_A" in k for k in sd)
    back = peft_state_dict_to_lora(sd, cfg)
    m1, m2 = merge_lora(params, lora), merge_lora(params, back)
    assert max(float((m1[n] - m2[n]).abs().max()) for n in m1) < 1e-6
    # an adapter missing a layer of its net is refused
    del sd[next(k for k in sd if ".layers.3." in k)]
    with pytest.raises(KeyError):
        peft_state_dict_to_lora(sd, cfg)


def test_merged_model_still_runs(setup):
    cfg, model, params = setup[1], setup[3], setup[4]
    lora = init_lora(params, _gen(3), rank=2)
    merged = merge_lora(params, lora)
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.tokenizer.vocab_size, (1, 4, 8)))
    h, _ = torch.func.functional_call(model, merged, (x,))
    assert h.shape == (1, 4, cfg.n_embd)


def test_peft_library_interop(setup, tmp_path):
    """The port's exported adapter loads through the real peft library onto
    a torch replica of the reference model, and peft's merge_and_unload
    gives the same effective weights as the port's merge_lora."""
    peft = pytest.importorskip("peft")
    from transformers import LlamaConfig, LlamaModel

    from midi_model_tpu_torch.train.checkpoint import CheckpointManager

    cfg, params = setup[1], setup[4]
    lora = {k: v + 0.01 for k, v in init_lora(params, _gen(2), rank=RANK).items()}
    adapter_dir = CheckpointManager(str(tmp_path / "ckpt"), cfg).export_peft_adapter(
        lora, rank=RANK, alpha=ALPHA)

    def hf(tc):
        return LlamaModel(LlamaConfig(
            vocab_size=tc.vocab_size, hidden_size=tc.hidden_size,
            num_hidden_layers=tc.num_layers, num_attention_heads=tc.num_heads,
            num_key_value_heads=tc.num_kv_heads or tc.num_heads,
            intermediate_size=tc.intermediate_size,
            max_position_embeddings=tc.max_position_embeddings,
            rms_norm_eps=tc.rms_norm_eps, rope_theta=tc.rope_theta, attention_bias=False))

    class Replica(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = hf(cfg.net)
            self.net_token = hf(cfg.net_token)
            self.lm_head = torch.nn.Linear(cfg.n_embd, cfg.tokenizer.vocab_size, bias=False)

    torch.manual_seed(0)
    replica = Replica()
    replica.load_state_dict(params, strict=False)
    merged = peft.PeftModel.from_pretrained(replica, adapter_dir).merge_and_unload()
    ours = merge_lora(params, lora, alpha=ALPHA)
    for name in (_weight("weight", "wq"), _weight("weight", "w_down", net="net_token")):
        np.testing.assert_allclose(merged.state_dict()[name].numpy(), ours[name].numpy(),
                                   atol=1e-6)


def _jax_lora(jparams, seed):
    """A JAX adapter (rank 4) with every B at 0.01, and the same adapter in
    the port's layout through peft's state dict."""
    jl = jlora.init_lora(jax.random.PRNGKey(seed), jparams, rank=RANK)
    for net in jl.values():
        for ab in net.values():
            ab["b"] = jnp.full_like(ab["b"], 0.01)
    return jl


def test_apply_matches_jax(setup):
    jcfg, cfg, jparams, _, params = setup
    jl = _jax_lora(jparams, 4)
    lora = peft_state_dict_to_lora(jlora.lora_to_peft_state_dict(jl), cfg)
    ours = to_jax_tree(apply_lora(params, lora, alpha=ALPHA), cfg)
    want = jax.tree.map(np.asarray, jlora.apply_lora(jparams, jl, alpha=ALPHA))
    flat_want = dict((jax.tree_util.keystr(k), v)
                     for k, v in jax.tree_util.tree_flatten_with_path(want)[0])
    for path, got in jax.tree_util.tree_flatten_with_path(ours)[0]:
        np.testing.assert_allclose(got, flat_want[jax.tree_util.keystr(path)], rtol=0,
                                   atol=1e-6, err_msg=jax.tree_util.keystr(path))


def _peft_np(lora):
    return {k: np.asarray(v) for k, v in lora.items()}


def test_lora_step_matches_jax(setup):
    jcfg, cfg, jparams, _, params = setup
    rng = np.random.default_rng(5)
    batch = rng.integers(3, cfg.tokenizer.vocab_size, (2, 2, 12, 8)).astype(np.int32)
    batch[:, :, -2:, :] = cfg.tokenizer.pad_id
    jl = _jax_lora(jparams, 6)
    lora = peft_state_dict_to_lora(jlora.lora_to_peft_state_dict(jl), cfg)

    # the gradients of one microbatch's loss with respect to the factors
    leaves = {k: v.clone().requires_grad_(True) for k, v in lora.items()}
    loss, _ = loss_fn(apply_lora(params, leaves, alpha=ALPHA), cfg, torch.from_numpy(batch[0]),
                      compute_dtype=torch.float32)
    loss.backward()

    def jloss(lo):
        return jtr.loss_fn(jlora.apply_lora(jparams, lo, alpha=ALPHA), jcfg,
                           jnp.asarray(batch[0]), jnp.float32)[0]

    jval, jgrads = jax.value_and_grad(jloss)(jl)
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    want = _peft_np(jlora.lora_to_peft_state_dict(jgrads))
    got = lora_to_peft_state_dict({k: v.grad for k, v in leaves.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(want[k]).max() > 0, k  # B != 0: A's gradient too
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(), err_msg=k)

    # one step, accumulation 2, f32, against optax, at the CLI's default lr.
    # Adam's first move is lr * g / (|g| + 1e-8): where a gradient is a few
    # eps, the f32 rounding of g moves the update by a fraction of lr that
    # is not small, so the tolerance on the factors is a tolerance on lr
    # times that fraction (it held at lr 1e-4, not at 1e-3, where one
    # element of a B factor moved by 1.8x the tolerance)
    kw = dict(lr=1e-4, warmup_steps=0, total_steps=100)
    jopt = jtr.make_optimizer(**kw)
    jstate, jm = jtr.make_lora_train_step(jcfg, jopt, lora_alpha=ALPHA, accum_steps=2,
                                          compute_dtype=jnp.float32)(
        jtr.init_train_state(jl, jopt), jparams, jnp.asarray(batch))
    opt = make_optimizer(**kw)
    base = {n: p.clone() for n, p in params.items()}
    state, m = tr.make_lora_train_step(cfg, opt, lora_alpha=ALPHA, accum_steps=2,
                                       compute_dtype=torch.float32)(
        init_train_state(lora, opt), base, batch)
    assert state.step == 1 and sorted(state.params) == sorted(lora)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = _peft_np(jlora.lora_to_peft_state_dict(jstate.params))
    got = lora_to_peft_state_dict(state.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
    for n, p in params.items():  # the frozen base, untouched
        assert torch.equal(base[n], p) and not base[n].requires_grad, n


def test_every_factor_is_decayed(setup):
    """As JAX's ``_decay_mask`` (``ndim >= 2``) over its stacked factors: a
    zero gradient still moves every factor by the decay."""
    params = setup[4]
    lora = {k: v + 0.01 for k, v in init_lora(params, _gen(7), rank=RANK).items()}
    opt = make_optimizer(lr=1e-3, weight_decay=0.1, warmup_steps=0, total_steps=10)
    state = init_train_state(lora, opt)
    updates, _ = opt.update({k: torch.zeros_like(v) for k, v in lora.items()},
                            state.opt_state, state.params)
    for k, u in updates.items():
        torch.testing.assert_close(u, -1e-3 * 0.1 * state.params[k].detach(), rtol=1e-6,
                                   atol=0)
    assert all(tr._decays(k, v) for k, v in lora.items())


def test_base_that_requires_grad_is_refused(setup):
    cfg, params = setup[1], setup[4]
    opt = make_optimizer()
    lora = init_lora(params, _gen(8), rank=RANK)
    step = tr.make_lora_train_step(cfg, opt, lora_alpha=ALPHA)
    base = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    batch = np.full((1, 1, 4, 8), cfg.tokenizer.pad_id, np.int32)
    with pytest.raises(ValueError, match="base"):
        step(init_train_state(lora, opt), base, batch)


def test_jax_midinet_forward_agrees_after_merge(setup):
    """The merged weights run through JAX's forward as the port's."""
    jcfg, cfg, jparams, model, params = setup
    jl = _jax_lora(jparams, 9)
    lora = peft_state_dict_to_lora(jlora.lora_to_peft_state_dict(jl), cfg)
    x = np.random.default_rng(1).integers(0, cfg.tokenizer.vocab_size, (1, 4, 8))
    h, _ = torch.func.functional_call(model, merge_lora(params, lora), (torch.as_tensor(x),))
    jh, _ = jmidinet.forward(jlora.merge_lora(jparams, jl), jcfg, jnp.asarray(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
