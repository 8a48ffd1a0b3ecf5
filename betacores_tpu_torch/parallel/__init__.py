"""The mesh and the builds over it (counterpart of betacores_tpu/parallel/):
the sharded point, group and Hilbert builds, and the lane-sharded BPSVI
batch. The lane-sharded MCMC chains, flow training and Shapley rounds live
beside their single-device runners (``inference.run_chains_sharded``,
``inference.make_sharded_shf_trainer``, ``valuation``'s ``mesh=``)."""

from .bpsvi_batch import make_sharded_bpsvi_batch
from .groups import ShardedGroupBuilder, ShardedGroupDraws, make_sharded_group_builder
from .hilbert import ShardedHilbertCoreset
from .mesh import (DATA_AXIS, LANE_AXES, SAMP_AXIS, Mesh, auto_mesh_shape, make_mesh,
                   require_axes, shard_data, shard_group_ids, shard_weights, world_of_one)
from .sharded import (ShardedGeneratorDraws, ShardedIncrementalBuilder,
                      make_sharded_incremental_builder)

__all__ = ["DATA_AXIS", "LANE_AXES", "SAMP_AXIS", "Mesh", "auto_mesh_shape", "make_mesh",
           "require_axes", "shard_data", "shard_group_ids", "shard_weights", "world_of_one",
           "ShardedGeneratorDraws", "ShardedGroupBuilder", "ShardedGroupDraws",
           "ShardedHilbertCoreset", "ShardedIncrementalBuilder",
           "make_sharded_bpsvi_batch", "make_sharded_group_builder",
           "make_sharded_incremental_builder"]
