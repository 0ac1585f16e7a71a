"""The particle mesh (counterpart of :mod:`qinfer_tpu.parallel`).

The JAX package shards the particle axis over a 1-D device mesh and lets
XLA insert the collectives; the port holds the D shards of a mesh in one
process (:class:`ParticleMesh`, whose collectives act on the
shard-stacked view of a tensor) and runs the same engine on them. The
two-level :class:`DistributedLiuWestResampler` resamples shard by shard
with the mesh's collectives, and :class:`DirectViewParallelizedModel`
spreads a likelihood over a pool of engines, as the reference package
does.
"""

from .mesh import (
    MeshSharding,
    ParticleMesh,
    initialize_multihost,
    make_particle_sharding,
)
from .directview import DirectViewParallelizedModel
from .resample import (
    DistributedLiuWestResampler,
    butterfly_exchange_schedule,
    shard_systematic_ancestors,
)

__all__ = [
    "ParticleMesh",
    "MeshSharding",
    "make_particle_sharding",
    "initialize_multihost",
    "DirectViewParallelizedModel",
    "DistributedLiuWestResampler",
    "shard_systematic_ancestors",
    "butterfly_exchange_schedule",
]
