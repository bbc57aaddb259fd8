"""The (data, model) mesh over ``torch.distributed``: one process per rank."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_sum, gather_shards,
                   make_mesh, process_shard, spawn)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "all_reduce_sum", "gather_shards",
           "make_mesh", "process_shard", "spawn"]
