"""The port's training over a ``(data, model)`` mesh, mirroring the sharded
case of ``tests/test_train.py``: one process group of four gloo ranks on
the CPU (``tests/_torch_train_mesh_worker.py``, spawned once for the module)
runs every case, and each is held here to the JAX package's sharded
``make_train_step(mesh=..., tp=...)`` on the same f32 weights and batch,
and to the port's single-device step.

Tolerances:
- every weight within 1e-4 after two f32 steps, as the JAX package holds
  its own sharded step to its unsharded one, at lr 1e-4.  The sums differ
  in order only (a row-parallel product from two halves, the gradients
  summed over ranks), but Adam's first move is lr * g / (|g| + 1e-8):
  where a gradient is small its last bits move the update by a fraction of
  lr.  At lr 1e-3 one token-net embedding element of the port's
  single-device step lies 1.4e-4 from the JAX package's single-device step
  on this batch, mesh or no mesh; at 1e-4 every weight holds (as
  ``test_torch_lora.py`` found for its step);
- one microbatch's gathered gradients as ``test_torch_train.py``'s: rtol
  1e-4 plus 1e-4 of each leaf's largest value; their global norm within
  rtol 1e-5 of one device's.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.models import lora as jlora
from midi_model_tpu.parallel.mesh import make_mesh as jax_make_mesh
from midi_model_tpu.train import trainer as jtr
from midi_model_tpu_torch.interop import to_jax_tree
from midi_model_tpu_torch.models.lora import lora_to_peft_state_dict, peft_state_dict_to_lora
from midi_model_tpu_torch.parallel import spawn
from midi_model_tpu_torch.train import trainer as tr
from midi_model_tpu_torch.train.sharding import (apply_lora_sharded, gather_params,
                                                 shard_params, split_axis,
                                                 train_local_config)

import _torch_train_mesh_worker as w
from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

SPAWN_LIMITS = dict(timeout_s=300.0, init_timeout_s=120.0)
TOL = 1e-4


def jax_lora_start():
    """A JAX adapter (rank 4) with every B at 0.01 (with B = 0, A's gradient
    is zero)."""
    jl = jlora.init_lora(jax.random.PRNGKey(6), jax_params(), rank=w.LORA_RANK)
    for net in jl.values():
        for ab in net.values():
            ab["b"] = jnp.full_like(ab["b"], 0.01)
    return jl


def jax_lora_np() -> dict:
    """:func:`jax_lora_start` in peft's layout, as numpy."""
    return {k: np.asarray(v) for k, v in jlora.lora_to_peft_state_dict(jax_lora_start()).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's {case: result}."""
    out = tmp_path_factory.mktemp("train_mesh")
    spawn(w.run_suite, 4, (str(out), jax_lora_np()), **SPAWN_LIMITS)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(4)]


def jax_config():
    return JaxConfig.get_config("v2", True, **w.DIMS)


def jax_params():
    return jax_params_from_sd(w.state_dict_of(), jax_config())


def same_on_every_rank(ranks, case):
    got = [r[case] for r in ranks if case in r]
    assert got and all(pickle.dumps(g) == pickle.dumps(got[0]) for g in got[1:]), case
    return got[0]


def jax_steps(batch: str, dp: int, tp: int, lora=None, **opt):
    """The JAX package's sharded step, ``STEPS`` f32 steps on a
    ``(dp, tp)`` mesh of CPU devices: (params or adapters, metrics)."""
    mesh = jax_make_mesh(jax.devices("cpu")[:dp * tp], dp=dp, tp=tp)
    data = jnp.asarray(w.batches()[batch])
    if lora is None:
        optimizer = jtr.make_optimizer(**{**w.OPT, **opt})
        step = jtr.make_train_step(jax_config(), optimizer, accum_steps=w.ACCUM,
                                   compute_dtype=jnp.float32, mesh=mesh, tp=tp > 1)
        state = jtr.init_train_state(jax_params(), optimizer)
        run = step
    else:
        optimizer = jtr.make_optimizer(**w.OPT)
        step = jtr.make_lora_train_step(jax_config(), optimizer, lora_alpha=w.LORA_ALPHA,
                                        accum_steps=w.ACCUM, compute_dtype=jnp.float32,
                                        mesh=mesh, tp=tp > 1)
        state = jtr.init_train_state(lora, optimizer)
        base = jax_params()

        def run(state, data):
            return step(state, base, data)
    metrics = []
    for _ in range(w.STEPS):
        state, m = run(state, data)
        metrics.append({k: float(v) for k, v in m.items()})
    return state.params, metrics


def port_single_device(batch: str, **opt):
    """The port's single-device step on the whole batch."""
    optimizer = tr.make_optimizer(**{**w.OPT, **opt})
    state = tr.init_train_state(w.params_of(), optimizer)
    step = tr.make_train_step(w.config_of(), optimizer, accum_steps=w.ACCUM,
                              compute_dtype=torch.float32)
    for _ in range(w.STEPS):
        state, _ = step(state, w.batches()[batch])
    return {n: p.detach().numpy() for n, p in state.params.items()}


def assert_jax_tree_close(ours: dict, theirs, tol: float = TOL):
    """The port's named weights against a JAX params tree, leaf by leaf."""
    mine = to_jax_tree({n: torch.from_numpy(p) for n, p in ours.items()}, w.config_of())
    want = dict((jax.tree_util.keystr(k), np.asarray(v))
                for k, v in jax.tree_util.tree_flatten_with_path(theirs)[0])
    for path, got in jax.tree_util.tree_flatten_with_path(mine)[0]:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(got), want[key], rtol=0, atol=tol, err_msg=key)


def assert_named_close(ours: dict, theirs: dict, tol: float = TOL):
    assert sorted(ours) == sorted(theirs)
    for n in ours:
        np.testing.assert_allclose(ours[n], theirs[n], rtol=0, atol=tol, err_msg=n)


# name -> (batch, dp, tp, optimizer keywords)
FULL_CASES = {
    "dp2": ("plain", 2, 1, {}),
    "tp2": ("plain", 1, 2, {}),
    "dp2_tp2": ("plain", 2, 2, {}),
    "pads_dp2": ("pads", 2, 1, {}),
    "pads_dp2_tp2": ("pads", 2, 2, {}),
    "clip_tp2": ("plain", 1, 2, {"grad_clip": w.CLIP}),
    "clip_dp2_tp2": ("pads", 2, 2, {"grad_clip": w.CLIP}),
}


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_sharded_step_matches_jax_and_one_device(ranks, case):
    """dp=2, tp=2 and dp=2 x tp=2 (the token net at one head a shard), on a
    batch whose data shards hold different pad counts, and with an active
    clip: the weights after two f32 steps within 1e-4 of the JAX package's
    sharded step and of the port's single-device step; the metrics (the
    global masked means) equal JAX's within rtol 1e-5."""
    batch, dp, tp, opt = FULL_CASES[case]
    got = same_on_every_rank(ranks, case)
    theirs, jmetrics = jax_steps(batch, dp, tp, **opt)
    assert_jax_tree_close(got["params"], theirs)
    assert_named_close(got["params"], port_single_device(batch, **opt))
    for mine, want in zip(got["metrics"], jmetrics):
        for k in ("loss", "acc"):
            np.testing.assert_allclose(mine[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", ["grads_tp2", "grads_dp2_tp2"])
def test_sharded_gradients_and_global_norm(ranks, case):
    """One microbatch's gradients under tp (and dp x tp), each shard's
    gathered, against the JAX package's on the whole microbatch; their
    global norm, split leaves summed over the model group and replicated
    leaves counted once, against one device's: above ``CLIP``, so the clip
    cases clip."""
    got = same_on_every_rank(ranks, case)
    mb = w.batches()["pads"][0]
    params = {n: p.clone().requires_grad_(True) for n, p in w.params_of().items()}
    loss, _ = tr.loss_fn(params, w.config_of(), mb, torch.float32)
    loss.backward()
    one = {n: p.grad for n, p in params.items()}
    norm = float(tr.global_norm(one))
    np.testing.assert_allclose(got["norm"], norm, rtol=1e-5)
    assert norm > 2 * w.CLIP
    (_, _), jgrads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jax_params(), jax_config(), jnp.asarray(mb), jnp.float32)
    mine = to_jax_tree({n: torch.from_numpy(g) for n, g in got["grads"].items()}, w.config_of())
    want = dict((jax.tree_util.keystr(k), np.asarray(v))
                for k, v in jax.tree_util.tree_flatten_with_path(jgrads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(mine)[0]:
        ref = want[jax.tree_util.keystr(path)]
        np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_unequal_pads_change_the_masked_mean(ranks):
    """The pads batch's data shards hold different target counts, so the
    mean of the shards' means is not the global masked mean the step
    reports."""
    cfg = w.config_of()
    pad = cfg.tokenizer.pad_id
    mb = w.batches()["pads"][0]
    counts = [int((mb[i:i + 2, 1:] != pad).sum()) for i in (0, 2)]
    assert counts[0] < counts[1] // 2
    first = same_on_every_rank(ranks, "pads_dp2")["metrics"][0]["loss"]
    params = w.params_of()
    halves = [float(tr.loss_fn(params, cfg, mb[i:i + 2], torch.float32)[0]) for i in (0, 2)]
    whole = float(tr.loss_fn(params, cfg, mb, torch.float32)[0])
    assert abs(np.mean(halves) - whole) > 1e-3
    assert abs(first - np.mean([float(tr.loss_fn(params, cfg, b, torch.float32)[0])
                                for b in w.batches()["pads"]])) < 1e-5


@pytest.mark.parametrize("case", ["remat_full_tp2", "remat_dots_tp2", "remat_dots_all_dp2_tp2"])
def test_remat_under_tp_equals_no_remat(ranks, case):
    """Every remat policy under tp: the recompute replays the layers'
    all-reduces, and the weights equal the run without remat."""
    got = same_on_every_rank(ranks, case)["params"]
    want = same_on_every_rank(ranks, "tp2" if case.endswith("_tp2") and "dp2" not in case
                              else "dp2_tp2")["params"]
    assert_named_close(got, want, tol=1e-6)


@pytest.mark.parametrize("case", ["lora_dp2", "lora_tp2", "lora_dp2_tp2"])
def test_lora_step_matches_jax(ranks, case):
    """The LoRA step over replicated adapters and sharded base weights: the
    adapters after two f32 steps within 1e-4 of the JAX package's sharded
    LoRA step, the base shards untouched."""
    dp, tp = {"lora_dp2": (2, 1), "lora_tp2": (1, 2), "lora_dp2_tp2": (2, 2)}[case]
    got = same_on_every_rank(ranks, case)
    assert got["base_untouched"]
    theirs, _ = jax_steps("plain", dp, tp, lora=jax_lora_start())
    want = {k: np.asarray(v) for k, v in jlora.lora_to_peft_state_dict(theirs).items()}
    mine = lora_to_peft_state_dict({k: torch.from_numpy(v) for k, v in got["lora"].items()})
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=0, atol=TOL, err_msg=k)


def test_sharded_eval_is_the_global_mean(ranks):
    """The loss without a gradient (``eval_step``'s, in f32, chunked) over
    each data shard's rows of an unequally padded microbatch, tp=2: the
    whole microbatch's masked mean on one device."""
    got = same_on_every_rank(ranks, "eval_dp2_tp2")
    with torch.no_grad():
        _, want = tr.loss_fn(w.params_of(), w.config_of(), w.batches()["pads"][0],
                             torch.float32, token_chunk=256)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, err_msg=k)


def test_operators_backward(ranks):
    """The three autograd operators on two ranks against their analytic
    gradients: ``copy_to_model`` sums the shards' gradients (1 + 2),
    ``reduce_from_model`` sums the values (1a + 2a) and passes each shard
    the gradient unchanged, ``gather_vocab`` concatenates the slices and
    hands each shard its slice of the gradient.  Under ``no_grad``,
    ``reduce_from_model`` sums in place (the serving path)."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    c = np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(2, 3)
    wv = np.linspace(0.5, 2.0, 12, dtype=np.float32).reshape(2, 6)
    for res in (r["ops"] for r in ranks if "ops" in r):
        rk = res["rank"]
        np.testing.assert_allclose(res["copy_grad"], np.full((2, 3), 3.0))
        np.testing.assert_allclose(res["reduce_value"], 3.0 * a)
        np.testing.assert_allclose(res["reduce_grad"], (rk + 1.0) * c, rtol=1e-6)
        np.testing.assert_allclose(res["gather_value"], np.concatenate([a, a + 10.0], axis=1))
        np.testing.assert_allclose(res["gather_grad"], wv[:, 3 * rk:3 * rk + 3], rtol=1e-6)
        assert res["no_grad_in_place"]
        np.testing.assert_allclose(res["no_grad_value"], np.full(3, 3.0))


def test_split_table_and_round_trip():
    """Both nets' q/k/v, gate and up split by rows, o_proj and down by
    columns, lm_head by vocab rows, the rest replicated; a shard's blocks
    gathered without a group are the weights themselves."""
    params = w.params_of()
    split = {n: split_axis(n) for n in params}
    assert split["lm_head.weight"] == 0
    assert split["net_token.layers.0.self_attn.q_proj.weight"] == 0
    assert split["net.layers.3.mlp.down_proj.weight"] == 1
    assert split["net.embed_tokens.weight"] is None
    assert split["net_token.layers.0.input_layernorm.weight"] is None
    assert split["net.norm.weight"] is None
    assert sum(a is not None for a in split.values()) == 7 * 5 + 1
    assert split_axis("net.layers.0.self_attn.q_proj.lora_A.weight") is None
    assert gather_params(shard_params(params, None), None).keys() == params.keys()


class _Shard:
    """A stand-in mesh for the shapes of shard ``rank`` of ``tp``."""

    def __init__(self, tp, rank):
        self.tp, self.model_rank = tp, rank


def test_shards_tile_the_weights():
    """tp=2: the two shards of each split weight, joined along its axis,
    are the weight; the local config halves both nets' heads and MLP
    widths with the head dims pinned."""
    params = w.params_of()
    shards = [shard_params(params, _Shard(2, r)) for r in range(2)]
    for n, p in params.items():
        axis = split_axis(n)
        if axis is None:
            assert all(s[n] is p for s in shards)
        else:
            assert torch.equal(torch.cat([s[n] for s in shards], dim=axis), p)
    local = train_local_config(w.config_of(), 2)
    cfg = w.config_of()
    for full, half in ((cfg.net, local.net), (cfg.net_token, local.net_token)):
        assert half.num_heads * 2 == full.num_heads and half.head_dim == full.head_dim
        assert half.intermediate_size * 2 == full.intermediate_size
    assert shards[0]["lm_head.weight"].shape[0] * 2 == cfg.tokenizer.vocab_size


def test_lora_shard_forms_its_block():
    """A shard's effective weights (replicated adapters over its base
    blocks) are its blocks of the single-device merge."""
    from midi_model_tpu_torch.models.lora import apply_lora

    params = w.params_of()
    lora = peft_state_dict_to_lora(jax_lora_np(), w.config_of())
    merged = apply_lora(params, lora, w.LORA_ALPHA)
    for r in range(2):
        mine = apply_lora_sharded(shard_params(params, _Shard(2, r)), lora, w.LORA_ALPHA,
                                  _Shard(2, r))
        want = shard_params(merged, _Shard(2, r))
        for n in want:
            torch.testing.assert_close(mine[n], want[n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dims, match", [
    (dict(n_layer=4, n_head=4, n_embd=64, n_inner=128), "net_token heads"),
    (dict(n_layer=4, n_head=12, n_embd=96, n_inner=192), "net_token heads"),
], ids=["token_net_one_head", "token_net_three_heads"])
def test_tp_must_divide_the_token_net_heads(dims, match):
    """The port splits by heads: tp=2 over a token net of 1 or 3 heads
    raises (the JAX package reshards a flattened axis instead)."""
    from midi_model_tpu_torch.models import MIDIModelConfig

    cfg = MIDIModelConfig.get_config("v2", True, **dims)
    with pytest.raises(ValueError, match=match):
        train_local_config(cfg, 2)
    with pytest.raises(ValueError, match=match):
        tr.make_train_step(cfg, tr.make_optimizer(), mesh=_Shard(2, 0))


def test_tp_must_divide_the_vocab():
    """tp=4 does not divide tv2o's 3406 tokens: raises, as the JAX package's
    ``device_put`` of the vocab-split head does."""
    from midi_model_tpu_torch.models import MIDIModelConfig

    cfg = MIDIModelConfig.get_config("v2", True, n_layer=4, n_head=16, n_embd=64, n_inner=128)
    assert cfg.tokenizer.vocab_size % 4
    with pytest.raises(ValueError, match="vocab"):
        train_local_config(cfg, 4)
