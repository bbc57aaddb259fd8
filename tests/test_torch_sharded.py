"""The port's sharded generation (``sampling.sharded``) across ranks,
mirroring ``tests/test_sharded.py``: one process group of two gloo ranks on
the CPU (``tests/_torch_mesh_worker.py``, spawned once for the module) runs
every case, and each is held here to the port's single-device decode and,
greedy, to the JAX package's mesh functions on the same f32 weights.

Rows must be identical.  Under tensor parallelism the event net's two
row-parallel products per layer are summed from two halves, an f32
rounding difference from the single-device product that moves a greedy or
sampled pick only at an exact near-tie; the fixed weights here have none.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.parallel.mesh import make_mesh as jax_make_mesh
from midi_model_tpu.sampling.sharded import generate_dp as jax_generate_dp
from midi_model_tpu.sampling.sharded import generate_tp as jax_generate_tp
from midi_model_tpu.sampling.sharded import tp_shard_params as jax_tp_shard_params
from midi_model_tpu_torch.parallel import spawn
from midi_model_tpu_torch.sampling import (build_mask_table, decode_events, generate,
                                           mask_tensors, normalize_prompt, prefill)
from midi_model_tpu_torch.sampling.sharded import shard_seed

import _torch_mesh_worker as w
from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

# one spawn for the module: its ranks' collectives time out after 120 s, and
# the whole suite must end within 300 s
SPAWN_LIMITS = dict(timeout_s=300.0, init_timeout_s=120.0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's {case: result}."""
    out = tmp_path_factory.mktemp("generation")
    world = w.SUITES["generation"][0]
    spawn(w.run_suite, world, ("generation", str(out)), **SPAWN_LIMITS)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def jax_tp_model():
    jcfg = JaxConfig.get_config("v2", True, **w.TP_DIMS)
    return jcfg, jax_params_from_sd(w.state_dict_of(w.TP_DIMS), jcfg)


def test_collectives_on_a_model_group(ranks):
    """``all_reduce_sum`` sums in place in the tensor's dtype on a group of
    two; ``gather_shards`` takes one array per data shard (a tp=2 mesh has
    one), the same on both ranks."""
    same, values, dtype, rows = w.same_on_every_rank(ranks, "collectives")
    assert same and values == [3.0, 3.0, 3.0] and dtype == "torch.bfloat16"
    np.testing.assert_array_equal(rows, np.zeros((1, 2), np.int32))


def test_process_shard_partitions(ranks):
    """Each rank's ``process_shard`` is disjoint from the other's; together
    they are the list."""
    parts = [r["process_shard"] for r in ranks]
    assert parts == [w.SHARD_FILES[0::2], w.SHARD_FILES[1::2]]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32_pools", "int8_pools"])
def test_generate_tp_greedy_matches_single_device_and_jax(ranks, kv_int8):
    """tp=2 (4 local heads x 32, MLP 128 a rank): greedy rows identical to
    the port's single-device ``generate`` and to the JAX package's
    ``generate_tp``, with f32 and with int8 pools."""
    got = w.same_on_every_rank(ranks, "tp_greedy_int8" if kv_int8 else "tp_greedy")
    ref = generate(w.model_of(w.TP_DIMS), w.config_of(w.TP_DIMS), **w.GEN_TP, greedy=True,
                   kv_int8=kv_int8)
    np.testing.assert_array_equal(got, ref)
    jcfg, params = jax_tp_model()
    mesh = jax_make_mesh(jax.devices()[:2], dp=1, tp=2)
    theirs = jax_generate_tp(jax_tp_shard_params(params, mesh), jcfg, mesh, **w.GEN_TP,
                             greedy=True, kv_int8=kv_int8)
    np.testing.assert_array_equal(got, np.asarray(theirs))


def test_generate_tp_sampled_matches_single_device(ranks):
    """Sampled, both model shards draw the same noise from the same seed:
    the rows are the single-device split path's."""
    got = w.same_on_every_rank(ranks, "tp_sampled")
    ref = generate(w.model_of(w.TP_DIMS), w.config_of(w.TP_DIMS), **w.GEN_TP, seed=5)
    np.testing.assert_array_equal(got, ref)


def test_decode_chunk_matches_each_shard_alone(ranks):
    """One dp=2 decode chunk: the gathered rows of shard i are shard i's
    rows decoded alone from its generator (``shard_seed(seed, i)``)."""
    rows, n_done, all_eos = w.same_on_every_rank(ranks, "dp_chunk")
    cfg, model = w.config_of(w.TINY), w.model_of(w.TINY)
    p = w.DP_CHUNK
    prompt = normalize_prompt(cfg.tokenizer, None, p["batch"])
    masks = mask_tensors(build_mask_table(cfg.tokenizer), "cpu")
    local = p["batch"] // 2
    assert rows.shape == (p["batch"], p["n_events"], cfg.tokenizer.max_token_seq)
    for i in range(2):
        sl = slice(i * local, (i + 1) * local)
        state = prefill(model, cfg, prompt[sl], p["max_seq"])
        gen = torch.Generator().manual_seed(shard_seed(p["seed"], i))
        state, rows_i, n_i = decode_events(model, cfg, state, masks, p["n_events"], 1.0,
                                           0.98, 20, gen)
        np.testing.assert_array_equal(rows[sl], rows_i.numpy())
        assert n_done[i] == n_i and all_eos[i] == state.all_eos


def test_generate_dp_shard_matches_single_device(ranks):
    """``generate_dp``: shard i's rows are single-device ``generate`` on its
    prompt rows with ``shard_seed(seed, i)``, pad past its own end."""
    got = w.same_on_every_rank(ranks, "dp_generate")
    cfg, model = w.config_of(w.TINY), w.model_of(w.TINY)
    kw = dict(w.GEN_DP)
    seed, local = kw.pop("seed"), kw.pop("batch_size") // 2
    assert got.shape[0] == 2 * local
    for i in range(2):
        ref = generate(model, cfg, batch_size=local, seed=shard_seed(seed, i), **kw)
        mine = got[i * local:(i + 1) * local]
        np.testing.assert_array_equal(mine[:, :ref.shape[1]], ref)
        assert (mine[:, ref.shape[1]:] == cfg.tokenizer.pad_id).all()


def test_generate_dp_greedy_matches_jax(ranks):
    """dp=2 greedy rows are the JAX package's ``generate_dp`` rows (and the
    port's single-device ones)."""
    got = w.same_on_every_rank(ranks, "dp_greedy")
    jcfg = JaxConfig.get_config("v2", True, **w.TINY)
    params = jax_params_from_sd(w.state_dict_of(w.TINY), jcfg)
    mesh = jax_make_mesh(jax.devices()[:2], dp=2, tp=1)
    theirs = np.asarray(jax_generate_dp(params, jcfg, mesh, **w.GEN_DP_GREEDY))
    np.testing.assert_array_equal(got, theirs)
    ref = generate(w.model_of(w.TINY), w.config_of(w.TINY), **w.GEN_DP_GREEDY)
    np.testing.assert_array_equal(got, ref)
