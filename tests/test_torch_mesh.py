"""The port's mesh layer on one process: the config's ``head_dim_override``,
``tp_local_config``, ``tp_shard_params``, ``process_shard`` and
``make_mesh`` at world size 1, held to the JAX package where it has the
same function.  The multi-rank paths are in ``test_torch_sharded.py`` and
``test_torch_batcher_mesh.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.models.config import TransformerConfig as JaxTransformerConfig
from midi_model_tpu.sampling.sharded import tp_local_config as jax_tp_local_config
from midi_model_tpu_torch.models import MIDIModelConfig, TransformerConfig
from midi_model_tpu_torch.parallel import (Mesh, all_reduce_sum, gather_shards, make_mesh,
                                           process_shard, spawn)
from midi_model_tpu_torch.sampling.sharded import (generate_dp, shard_seed, tp_local_config,
                                                   tp_shard_params)
from midi_model_tpu_torch.serve import ContinuousBatcher

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_mesh_worker import (TINY, TP_DIMS, config_of, fail_on_rank, model_of,
                                sleep_forever, state_dict_of)


def fake_mesh(dp: int, tp: int, data_rank: int = 0, model_rank: int = 0) -> Mesh:
    """One rank's view of a larger mesh, without its groups: enough for the
    code that runs before any collective."""
    return Mesh(dp=dp, tp=tp, data_rank=data_rank, model_rank=model_rank,
                data_group=None, model_group=None, host_group=None,
                device=torch.device("cpu"))


@pytest.mark.parametrize("cls", ["TransformerConfig", "MIDIModelConfig"])
def test_config_fields_match_jax(cls):
    """Every dataclass field of the port's config, by name, type and
    default, is the JAX package's: a dropped field fails here."""
    ours = {"TransformerConfig": TransformerConfig, "MIDIModelConfig": MIDIModelConfig}[cls]
    theirs = {"TransformerConfig": JaxTransformerConfig, "MIDIModelConfig": JaxConfig}[cls]

    def fields(c):
        return [(f.name, str(f.type), f.default) for f in dataclasses.fields(c)]

    assert fields(ours) == fields(theirs)


def test_head_dim_override_round_trip():
    """The override pins the head dim and survives a field round trip; a
    global config's HF dict round trip is unchanged."""
    net = config_of(TP_DIMS).net
    assert net.head_dim_override is None and net.head_dim == 32
    pinned = dataclasses.replace(net, num_heads=4, head_dim_override=32)
    assert pinned.head_dim == 32  # hidden / heads would be 64
    assert TransformerConfig(**dataclasses.asdict(pinned)) == pinned
    back = TransformerConfig.from_hf_dict(net.to_hf_dict())
    assert back.to_hf_dict() == net.to_hf_dict() and back.head_dim == net.head_dim


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_local_config_matches_jax(tp):
    ours = tp_local_config(config_of(TP_DIMS), tp)
    theirs = jax_tp_local_config(JaxConfig.get_config("v2", True, **TP_DIMS), tp)
    for name in ("net", "net_token"):
        assert dataclasses.asdict(getattr(ours, name)) == dataclasses.asdict(getattr(theirs, name))
    assert ours.net.head_dim == 32 and ours.net.num_heads * tp == 8
    assert ours.net.hidden_size == 256 and ours.net_token == config_of(TP_DIMS).net_token


def test_tp_local_config_must_divide():
    with pytest.raises(ValueError, match="must divide"):
        tp_local_config(config_of(TP_DIMS), 3)


@pytest.mark.parametrize("source", ["model", "state_dict"])
def test_tp_shard_params_slices(source):
    """Each model shard's event-net matrices are its numpy split of the
    full ones (column-parallel rows, row-parallel columns); every other
    weight is whole."""
    sd = state_dict_of(TP_DIMS)
    cfg = config_of(TP_DIMS)
    full = model_of(TP_DIMS) if source == "model" else sd
    for m in range(2):
        local = tp_shard_params(full, fake_mesh(1, 2, model_rank=m), config=cfg)
        assert local.config.net.num_heads == 4 and local.dtype == torch.float32
        got = {k: v.numpy() for k, v in local.state_dict().items()}
        assert set(got) == set(sd)
        for name, w in sd.items():
            kind = name.split(".")[-2]
            if name.startswith("net.layers.") and kind in ("q_proj", "k_proj", "v_proj",
                                                           "gate_proj", "up_proj"):
                want = np.split(w, 2, axis=0)[m]
            elif name.startswith("net.layers.") and kind in ("o_proj", "down_proj"):
                want = np.split(w, 2, axis=1)[m]
            else:
                want = w
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_process_shard_single_process():
    files = [f"f{i}" for i in range(11)]
    assert process_shard(files) == files


def test_make_mesh_world_one():
    """No process group: one rank, no groups; the collectives are the
    identity.  A mesh larger than the world raises."""
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.tp, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0)
    assert mesh.model_group is mesh.data_group is mesh.host_group is None
    assert mesh.device == torch.device("cpu") and mesh.shape == {"data": 1, "model": 1}
    x = torch.arange(4.0)
    assert all_reduce_sum(x, mesh.model_group) is x
    rows = np.arange(6).reshape(2, 3)
    assert gather_shards(mesh, rows) is rows
    with pytest.raises(ValueError, match="world size"):
        make_mesh(tp=2, device="cpu")


@pytest.mark.parametrize("device", [None, "cuda:1"])
def test_make_mesh_makes_its_card_current(monkeypatch, device):
    """The kernels launch on the current device, so the mesh's card must be
    it: by default ``cuda:(rank % device_count)``, else the one named.  The
    card is faked (the CPU has none); the CPU is never made current."""
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: current.append(torch.device(d)))
    mesh = make_mesh(device=device)
    assert mesh.device == torch.device(device or "cuda:0") and current == [mesh.device]
    make_mesh(device="cpu")
    assert current == [mesh.device]


def test_shard_seed():
    assert shard_seed(11, 0) == 11
    seeds = {shard_seed(11, i) for i in range(8)}
    assert len(seeds) == 8 and shard_seed(11, 3) == shard_seed(11, 3)


def test_mesh_batch_and_slots_must_divide():
    """The batcher's slots and generate_dp's batch must divide by dp
    (raised before any collective)."""
    model, cfg = model_of(TINY), config_of(TINY)
    with pytest.raises(ValueError, match="divisible"):
        ContinuousBatcher(model, cfg, n_slots=6, mesh=fake_mesh(4, 1))
    with pytest.raises(ValueError, match="divisible"):
        generate_dp(model, cfg, fake_mesh(4, 1), batch_size=6, max_len=4)


def test_spawn_raises_when_a_rank_fails():
    """A rank that raises fails the spawn at once; the other rank, left
    waiting on nothing, is killed."""
    with pytest.raises(RuntimeError, match="ranks failed"):
        spawn(fail_on_rank, 2, (1,), timeout_s=60, init_timeout_s=30)


def test_spawn_kills_ranks_past_its_time_limit():
    with pytest.raises(TimeoutError, match="still running"):
        spawn(sleep_forever, 1, timeout_s=5, init_timeout_s=30)
