from .hilbert import ShardedHilbertCoreset
from .mesh import (DATA_AXIS, SAMP_AXIS, Mesh, auto_mesh_shape, make_mesh,
                   require_axes, shard_data, shard_weights, world_of_one)
from .sharded import (ShardedGeneratorDraws, ShardedIncrementalBuilder,
                      make_sharded_incremental_builder)


def make_sharded_group_builder(*args, **kwargs):
    """The group build over a mesh (the JAX package's parallel/groups.py).
    Not ported yet."""
    raise NotImplementedError("the sharded group build is not ported yet "
                              "(ROADMAP Queue A item 12)")


def make_sharded_bpsvi_batch(*args, **kwargs):
    """BPSVI lanes sharded over a mesh (the JAX package's
    parallel/bpsvi_batch.py). Not ported yet: ``coresets.bpsvi_build_batch``
    runs the lanes on one device."""
    raise NotImplementedError("the sharded BPSVI batch is not ported yet "
                              "(ROADMAP Queue A item 12)")


__all__ = ["DATA_AXIS", "SAMP_AXIS", "Mesh", "auto_mesh_shape", "make_mesh",
           "require_axes", "shard_data", "shard_weights", "world_of_one",
           "ShardedGeneratorDraws", "ShardedHilbertCoreset",
           "ShardedIncrementalBuilder", "make_sharded_incremental_builder",
           "make_sharded_bpsvi_batch", "make_sharded_group_builder"]
