from .mesh import (DATA_AXIS, SAMP_AXIS, Mesh, auto_mesh_shape, make_mesh,
                   require_axes, shard_data, shard_weights, world_of_one)
from .sharded import (ShardedGeneratorDraws, ShardedIncrementalBuilder,
                      make_sharded_incremental_builder)

__all__ = ["DATA_AXIS", "SAMP_AXIS", "Mesh", "auto_mesh_shape", "make_mesh",
           "require_axes", "shard_data", "shard_weights", "world_of_one",
           "ShardedGeneratorDraws",
           "ShardedIncrementalBuilder", "make_sharded_incremental_builder"]
