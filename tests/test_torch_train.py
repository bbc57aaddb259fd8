"""The port's trainer (``midi_model_tpu_torch.train``) on the CPU against the
JAX package's, mirroring ``tests/test_train.py`` and
``tests/test_loss_chunked.py``: one tiny model's weights in both packages.

Tolerances:
- f32 compute: loss and every gradient leaf within rtol 1e-4 (plus atol
  1e-4 of the leaf's largest value), summation order only;
- bf16 compute: loss within rtol 1e-3, and every gradient leaf within 10%
  of the leaf's largest value with a cosine of at least 0.999 (the two
  packages round their bf16 products at the same points but sum in another
  order; measured 3.2% and 0.9998);
- chunked against unchunked: 1e-5 loss, 2e-5 gradients (as the JAX test);
- the optimizer fed the same gradients as optax: updates and moments within
  1e-6 over three steps; one train step's weights within 1e-6 but where a
  near-zero gradient's rounding decides Adam's first move (see the test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from midi_model_tpu.train import sched as jsched
from midi_model_tpu.train import trainer as jtr
from midi_model_tpu_torch.interop import to_jax_tree
from midi_model_tpu_torch.models.midinet import param_count
from midi_model_tpu_torch.train import (eval_step, init_params, init_train_state,
                                        linear_warmup_decay, loss_fn, make_optimizer,
                                        make_train_step)
from midi_model_tpu_torch.train import trainer as tr

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg, params, model, _ = tiny_models(seed=0)
    return jcfg, cfg, params, {n: p.detach() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def batch(tiny):
    """[2 microbatches, B=4, L=16, T=8] with pad rows at the end."""
    cfg = tiny[1]
    rng = np.random.default_rng(0)
    b = rng.integers(3, cfg.tokenizer.vocab_size, (2, 4, 16, 8)).astype(np.int32)
    b[:, :, -2:, :] = cfg.tokenizer.pad_id
    return b


def _leaf(params):
    return {n: p.clone().requires_grad_(True) for n, p in params.items()}


def _port_loss_and_grads(params, cfg, mb, **kw):
    p = _leaf(params)
    loss, metrics = loss_fn(p, cfg, torch.from_numpy(mb), **kw)
    loss.backward()
    return float(loss), float(metrics["acc"]), {n: t.grad for n, t in p.items()}


def _compare_grads(ours: dict, ref: dict, cfg, check):
    mine = to_jax_tree(ours, cfg)
    paths = jax.tree_util.tree_flatten_with_path(mine)[0]
    want = dict((jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref))[0])
    for path, got in paths:
        check(got, want[jax.tree_util.keystr(path)], jax.tree_util.keystr(path))


def test_loss_and_grads_match_jax_f32(tiny, batch):
    jcfg, cfg, params, ours = tiny
    mb = batch[0]
    loss, acc, grads = _port_loss_and_grads(ours, cfg, mb, compute_dtype=torch.float32)
    (jloss, jm), jgrads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        params, jcfg, jnp.asarray(mb), jnp.float32)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    assert acc == pytest.approx(float(jm["acc"]), abs=1e-6)

    def check(got, want, name):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)

    _compare_grads(grads, jgrads, cfg, check)


def test_loss_and_grads_match_jax_bf16(tiny, batch):
    """bf16 compute with f32 master weights; embedding rows cast after the
    gather in both packages."""
    jcfg, cfg, params, ours = tiny
    mb = batch[1]
    loss, _, grads = _port_loss_and_grads(ours, cfg, mb)
    (jloss, _), jgrads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        params, jcfg, jnp.asarray(mb))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-3)

    def check(got, want, name):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.1 * scale, name
        cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= 0.999, (name, cos)

    _compare_grads(grads, jgrads, cfg, check)


def test_loss_matches_torch_cross_entropy(tiny, batch):
    """``train_logits`` with ``F.cross_entropy(ignore_index=pad)`` gives the
    loss (as ``tests/test_train.py``'s CE check)."""
    _, cfg, _, ours = tiny
    mb = torch.from_numpy(batch[0])
    loss, _ = loss_fn(ours, cfg, mb, compute_dtype=torch.float32)
    model = tr._structure(cfg)
    out = torch.func.functional_call(tr._Method(model), {f"model.{n}": p for n, p in ours.items()},
                                     ("train_logits", mb.long()))
    ref = torch.nn.functional.cross_entropy(out.logits.reshape(-1, out.logits.shape[-1]),
                                            out.targets.reshape(-1),
                                            ignore_index=cfg.tokenizer.pad_id)
    assert abs(float(loss) - float(ref)) < 1e-4
    assert param_count(model) == sum(p.numel() for p in ours.values())


@pytest.mark.parametrize("chunk", [3, 7])
def test_token_chunk_matches_unchunked(tiny, batch, chunk):
    _, cfg, _, ours = tiny
    mb = batch[0]
    full, acc_full, g_full = _port_loss_and_grads(ours, cfg, mb, compute_dtype=torch.float32)
    part, acc_part, g_part = _port_loss_and_grads(ours, cfg, mb, compute_dtype=torch.float32,
                                                  token_chunk=chunk)
    assert abs(full - part) < 1e-5 and abs(acc_full - acc_part) < 1e-6
    for n in g_full:
        np.testing.assert_allclose(g_part[n].numpy(), g_full[n].numpy(), atol=2e-5, err_msg=n)


def test_remat_and_sample_positions_match_jax(tiny, batch):
    """``remat`` recomputes each layer: the same loss and gradients; the
    loss over a subset of event positions equals JAX's."""
    jcfg, cfg, params, ours = tiny
    mb = batch[0]
    plain, _, g_plain = _port_loss_and_grads(ours, cfg, mb, compute_dtype=torch.float32)
    remat, _, g_remat = _port_loss_and_grads(ours, cfg, mb, compute_dtype=torch.float32,
                                             remat=True)
    assert plain == remat
    for n in g_plain:
        torch.testing.assert_close(g_remat[n], g_plain[n], rtol=0, atol=1e-7)
    positions = np.asarray([0, 3, 4, 12])
    loss, _ = loss_fn(ours, cfg, torch.from_numpy(mb), compute_dtype=torch.float32,
                      sample_positions=torch.from_numpy(positions))
    jloss, _ = jtr.loss_fn(params, jcfg, jnp.asarray(mb), jnp.float32,
                           sample_positions=jnp.asarray(positions))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_schedule_matches_jax():
    ours, ref = linear_warmup_decay(1e-3, 10, 110), jsched.linear_warmup_decay(1e-3, 10, 110)
    for step in (0, 5, 10, 60, 109, 110, 200):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-7, abs=0), step
    assert ours(0) == 0.0 and ours(110) == 0.0


def test_optimizer_matches_optax(tiny):
    """The same gradients through the port's chain and the JAX trainer's
    optax chain: three steps, each the mean of two microbatches' gradients
    (accumulation 2); the first clipped by the global norm, the last too
    small to clip.  Updates and both moments agree; the norm scales get no
    weight decay."""
    jcfg, cfg, params, ours = tiny
    kw = dict(lr=1e-3, weight_decay=0.1, warmup_steps=2, total_steps=50, grad_clip=1.0)
    jopt = jtr.make_optimizer(**kw)
    jstate = jopt.init(params)
    opt = make_optimizer(**kw)
    masters = {n: p.clone() for n, p in ours.items()}
    state = opt.init(masters)
    rng = np.random.default_rng(3)
    for step, size in enumerate((1.0, 0.01, 1e-5)):
        micro = [{n: (rng.normal(size=p.shape) * size).astype(np.float32)
                  for n, p in ours.items()} for _ in range(2)]
        grads = {n: (torch.from_numpy(micro[0][n]) + torch.from_numpy(micro[1][n])) * 0.5
                 for n in ours}
        updates, state = opt.update(grads, state, masters)
        jgrads = jax.tree.map(jnp.asarray, to_jax_tree(grads, cfg))
        jupdates, jstate = jopt.update(jgrads, jstate, params)
        params = optax.apply_updates(params, jupdates)
        with torch.no_grad():
            for n in masters:
                masters[n] += updates[n]
        adam = jstate[1]
        for ours_tree, ref in ((updates, jupdates), (state.mu, adam.mu), (state.nu, adam.nu),
                               (masters, params)):
            _compare_grads(ours_tree, ref, cfg, lambda got, want, name: np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-6, err_msg=f"step {step}: {name}"))
    assert state.count == 3 and int(adam.count) == 3
    # a zero gradient moves only the decayed leaves: as the JAX package's
    # ``ndim >= 2`` mask over its stacked layout, every leaf but the final
    # norm scales (the per-layer norm scales are 2-D leaves there)
    zero = {n: torch.zeros_like(p) for n, p in masters.items()}
    fresh = make_optimizer(**{**kw, "warmup_steps": 0})
    updates, _ = fresh.update(zero, fresh.init(masters), masters)
    still = sorted(n for n, u in updates.items() if not u.any())
    assert still == ["net.norm.weight", "net_token.norm.weight"]


def test_train_step_matches_jax(tiny, batch):
    """One step with accumulation 2 at f32: the master weights after it
    agree with the JAX trainer's."""
    jcfg, cfg, params, ours = tiny
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    jopt = jtr.make_optimizer(**kw)
    jstate, _ = jtr.make_train_step(jcfg, jopt, accum_steps=2, compute_dtype=jnp.float32)(
        jtr.init_train_state(params, jopt), jnp.asarray(batch))
    opt = make_optimizer(**kw)
    state, metrics = make_train_step(cfg, opt, accum_steps=2, compute_dtype=torch.float32)(
        init_train_state(ours, opt), batch)
    assert state.step == 1 and 0.0 <= float(metrics["acc"]) <= 1.0
    # Adam's first step moves each weight by lr * g / (|g| + eps): where a
    # gradient is near zero (rows an embedding gather hit from several
    # positions, summed in another order) its f32 rounding decides the
    # move.  So every weight lies within lr of JAX's, and all but 0.1% of
    # each leaf within 1e-6.
    def check(got, want, name):
        diff = np.abs(got - want)
        assert diff.max() <= 1e-3 and (diff > 1e-6).mean() <= 1e-3, (name, diff.max())

    _compare_grads(state.params, jstate.params, cfg, check)


def test_loss_decreases(tiny, batch):
    _, cfg, _, ours = tiny
    opt = make_optimizer(lr=1e-3, warmup_steps=2, total_steps=1000)
    step = make_train_step(cfg, opt, accum_steps=2)
    state = init_train_state(ours, opt)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert state.step == 6 and state.opt_state.count == 6
    assert all(p.dtype == torch.float32 for p in state.params.values())


def test_eval_step_matches_jax(tiny, batch):
    """bf16 compute, the token net in chunks of 256, as ``eval_step``."""
    jcfg, cfg, params, ours = tiny
    m = eval_step(ours, cfg, batch[0])
    jm = jtr.eval_step(params, jcfg, jnp.asarray(batch[0]))
    assert 0.0 <= float(m["acc"]) <= 1.0 and float(m["loss"]) > 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
    assert not m["loss"].requires_grad


def test_init_params_are_f32_on_the_named_device(tiny):
    cfg = tiny[1]
    params = init_params(cfg, seed=1, device="cpu")
    assert set(params) == set(tiny[3])
    assert all(p.dtype == torch.float32 and p.device.type == "cpu" for p in params.values())
    assert torch.equal(params["net.norm.weight"], torch.ones_like(params["net.norm.weight"]))


@pytest.mark.parametrize("policy", ["dots", "dots_all"])
def test_selective_remat_matches_full(tiny, batch, policy, monkeypatch):
    """``--remat dots`` / ``dots_all`` (the JAX package's
    ``dots_with_no_batch_dims_saveable`` / ``dots_saveable``): f32 loss and
    gradients within 1e-6 of ``--remat full``.  What each saves shows in
    what the backward runs again: "full" recomputes every product and every
    attention forward, "dots" the attention forwards but no product,
    "dots_all" neither (its attention outputs are saved through the
    forward's operator)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from midi_model_tpu_torch.ops import attention as at

    _, cfg, _, ours = tiny
    mb = batch[0]
    calls = {"attention": 0, "mm": 0}
    reference = at._reference_with_lse

    def counted(*args):
        calls["attention"] += 1
        return reference(*args)

    class CountMatmuls(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm):
                calls["mm"] += 1
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(at, "_reference_with_lse", counted)
    runs = {}
    for remat in (False, "full", policy):
        calls.update(attention=0, mm=0)
        with CountMatmuls():
            loss, _, grads = _port_loss_and_grads(ours, cfg, mb, compute_dtype=torch.float32,
                                                  remat=remat)
        runs[remat] = (loss, grads, dict(calls))
    full, ours_ = runs["full"], runs[policy]
    assert abs(ours_[0] - full[0]) <= 1e-6
    for n in full[1]:
        torch.testing.assert_close(ours_[1][n], full[1][n], rtol=0, atol=1e-6)
    n_layers = cfg.net.num_layers + cfg.net_token.num_layers
    plain, counts_full, counts = runs[False][2], full[2], ours_[2]
    assert plain["attention"] == n_layers and counts_full["attention"] == 2 * n_layers
    assert counts_full["mm"] > plain["mm"]  # full recomputes the products
    assert counts["mm"] == plain["mm"]  # the selective policies save them
    assert counts["attention"] == (2 * n_layers if policy == "dots" else n_layers)
