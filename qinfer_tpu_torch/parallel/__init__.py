"""The particle mesh (counterpart of :mod:`qinfer_tpu.parallel`).

The JAX package shards the particle axis over a 1-D device mesh and lets
XLA insert the collectives; the port's :class:`ParticleMesh` holds the D
shards of an ensemble in one process, or one shard a rank of a
``torch.distributed`` group after :func:`initialize_multihost`, and its
collectives act on the stacked view of the shards a process holds; the
engine reduces its sums over particles through the mesh. The two-level
:class:`DistributedLiuWestResampler` resamples shard by shard with the
mesh's collectives, :class:`DirectViewParallelizedModel` spreads a
likelihood over a pool of engines, as the reference package does,
:mod:`.worker` is the entry point of one rank, and :mod:`.runs` holds the
runs that a mesh across processes is held to against a one-process mesh.
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
