"""The port's continuous batcher over a mesh (``serve.batcher`` with
``mesh=``), mirroring ``tests/test_batcher_dp.py`` and
``tests/test_batcher_tp.py``: one process group of eight gloo ranks on the
CPU (``tests/_torch_mesh_worker.py``, spawned once for the module) runs
dp=4, dp=8 with a request submitted mid-run, tp=2, dp=2 x tp=2 and tp=2 on
int8 pools, each greedy and sampled.  Every rank must return the same
records; each request's rows and finish reason must be those of the port's
single-device batcher (the noise is per request, so sampled rows too) and,
greedy, those of the JAX package's batcher over the same mesh shape on the
same f32 weights.  Rows are compared exactly (see ``test_torch_sharded.py``
on the tensor-parallel sums)."""

import pickle

import jax
import pytest

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.parallel.mesh import make_mesh as jax_make_mesh
from midi_model_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
from midi_model_tpu_torch.parallel import spawn
from midi_model_tpu_torch.serve import ContinuousBatcher

import _torch_mesh_worker as w
from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

# one spawn for the module: its ranks' collectives time out after 120 s, and
# the whole suite must end within 300 s
SPAWN_LIMITS = dict(timeout_s=300.0, init_timeout_s=120.0)
PLANS = w.batcher_plans(w.config_of(w.TINY).tokenizer)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's {case: [(rows, reason), ...]}."""
    out = tmp_path_factory.mktemp("batcher")
    world = w.SUITES["batcher"][0]
    spawn(w.run_suite, world, ("batcher", str(out)), **SPAWN_LIMITS)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def assert_same_records(got, want):
    assert len(got) == len(want)
    for (rows, reason), (rows_w, reason_w) in zip(got, want):
        assert reason == reason_w
        assert rows.shape == rows_w.shape and (rows == rows_w).all()


@pytest.mark.parametrize("mode", list(w.MODES))
@pytest.mark.parametrize("name", list(PLANS))
def test_mesh_batcher_matches_single_device(ranks, name, mode):
    """Every request's rows and reason equal the single-device batcher's."""
    got = w.same_on_every_rank(ranks, f"{name}_{mode}")
    _, _, kw, plan = PLANS[name]
    ref = w.drive(ContinuousBatcher(w.model_of(w.TINY), w.config_of(w.TINY), **kw,
                                    **w.MODES[mode]), plan)
    assert_same_records(got, ref)
    assert all(len(rows) for rows, _ in got)


@pytest.mark.parametrize("name", list(PLANS))
def test_mesh_batcher_greedy_matches_jax_mesh_batcher(ranks, name):
    """Greedy, every request's rows and reason equal the JAX package's
    batcher over the same (data, model) mesh."""
    got = w.same_on_every_rank(ranks, f"{name}_greedy")
    dp, tp, kw, plan = PLANS[name]
    jcfg = JaxConfig.get_config("v2", True, **w.TINY)
    params = jax_params_from_sd(w.state_dict_of(w.TINY), jcfg)
    mesh = jax_make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
    ref = w.drive(JaxBatcher(params, jcfg, mesh=mesh, greedy=True, **kw), plan)
    assert_same_records(got, ref)
