"""The (data, model) mesh over ``torch.distributed``: one process per rank."""

from .collectives import copy_to_model, gather_vocab, reduce_from_model
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_sum, data_shard, gather_shards,
                   make_mesh, process_shard, spawn)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "all_reduce_sum", "copy_to_model",
           "data_shard", "gather_shards", "gather_vocab", "make_mesh", "process_shard",
           "reduce_from_model", "spawn"]
