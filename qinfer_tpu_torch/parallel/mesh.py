"""The particle mesh (counterpart of :mod:`qinfer_tpu.parallel.mesh`).

A :class:`ParticleMesh` is a 1-D mesh of D shards over a list of torch
devices. A tensor sharded over it along the particle axis is D equal
contiguous blocks of that axis (the JAX package's ``P('particles')``
layout). The mesh's collectives act on the shard-stacked view
``(D, n/D, ...)`` of such a tensor (:meth:`ParticleMesh.shard`):
``psum`` sums over the shards in mesh order, ``all_gather`` gives every
shard the stacked view, ``ppermute`` rolls it along the shard axis and
``axis_index`` numbers the shards. That is ``shard_map`` written as a
batch over the shard axis; a backend over a process group would give the
same four methods each shard's own block.

One process holds every shard here, so the shards of one ensemble share
one device: ``ParticleMesh([dev] * 8)`` is a virtual mesh of 8 shards on
``dev``, the counterpart of the JAX package's
``--xla_force_host_platform_device_count``. On it, sharding is a layout:
the engine's arithmetic is the unsharded one's, and only
:class:`~qinfer_tpu_torch.parallel.resample.DistributedLiuWestResampler`
changes the algorithm, where the caller asks for it. A mesh over
distinct devices serves trials (``perf_test_scan_batch``). One ensemble
sharded over distinct devices, and a mesh that spans processes, raise
:class:`NotImplementedError` (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import DEFAULT_DEVICE, resolve_device

__all__ = ["ParticleMesh", "MeshSharding", "make_particle_sharding",
           "initialize_multihost", "placement", "shard_state"]

#: where the work that is not ported yet waits
_LATER = "ROADMAP queue 1, item 15"


def _normalized(device):
    """``resolve_device(device)`` with a CUDA device's index filled in."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """How a tensor lies on a :class:`ParticleMesh`: ``spec`` names, for
    each leading axis of the tensor, the mesh axis it is split along
    (``None``: whole on every shard), as a JAX ``PartitionSpec`` does;
    ``()`` is replicated."""

    mesh: "ParticleMesh"
    spec: tuple

    @property
    def device(self):
        """The device every shard lives on."""
        return self.mesh.device

    @property
    def is_particle_sharding(self):
        return self.spec == (self.mesh.axis_name,)

    def place(self, tensor):
        """``tensor`` on the mesh's device, its sharded axis checked to
        divide into equal blocks."""
        if self.spec and self.spec[0] is not None:
            self.mesh.check_divides(tensor.shape[0])
        return tensor.to(self.device)


class ParticleMesh:
    """A 1-D mesh of shards over torch devices.

    :param devices: the shards' devices, in mesh order (default: every
        CUDA device; raises without one, as the entry points do). A device
        may repeat: ``[dev] * 8`` is 8 shards on one device.
    :param str axis_name: the mesh axis (``'particles'``; ``'trials'`` for
        a trial mesh).
    """

    def __init__(self, devices=None, axis_name="particles"):
        if devices is None:
            resolve_device(DEFAULT_DEVICE)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = tuple(_normalized(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = str(axis_name)

    @property
    def n_devices(self):
        """D, the number of shards."""
        return len(self.devices)

    @property
    def device(self):
        """The one device that holds every shard of a sharded tensor."""
        first = self.devices[0]
        if any(d != first for d in self.devices):
            raise NotImplementedError(
                f"sharding one ensemble over distinct devices "
                f"({', '.join(sorted({str(d) for d in self.devices}))}) is "
                f"not ported yet ({_LATER}); a mesh over distinct devices "
                f"runs trials (perf_test_scan_batch)")
        return first

    def _sharding(self, spec):
        self.device  # one ensemble's shards share one device
        return MeshSharding(self, spec)

    @property
    def particle_sharding(self):
        """Sharding of per-particle vectors ``(n,)``."""
        return self._sharding((self.axis_name,))

    @property
    def location_sharding(self):
        """Sharding of particle location matrices ``(n, d)``."""
        return self._sharding((self.axis_name, None))

    @property
    def replicated(self):
        return self._sharding(())

    def pad_particles(self, n_particles):
        """``n_particles`` rounded up to a multiple of the mesh size (equal
        shards)."""
        k = self.n_devices
        return int(-(-n_particles // k) * k)

    def check_divides(self, n_particles):
        if n_particles % self.n_devices:
            raise ValueError(
                f"{n_particles} particles do not split into {self.n_devices} "
                f"equal shards: use mesh.pad_particles({n_particles}) = "
                f"{self.pad_particles(n_particles)}")

    def shard_updater(self, updater):
        """Shard an existing updater's ensemble over this mesh (the
        updater must live on the mesh's device: its generator does)."""
        sharding = self.particle_sharding
        placement(updater.device, sharding)
        updater.state = shard_state(updater.state, sharding)
        updater.sharding = sharding
        return updater

    # -- collectives over the shard axis ------------------------------------

    def shard(self, tensor):
        """The shard-stacked view ``(D, n/D, ...)`` of a tensor whose first
        axis is sharded over the mesh."""
        self.check_divides(tensor.shape[0])
        return tensor.reshape((self.n_devices, -1) + tuple(tensor.shape[1:]))

    @staticmethod
    def unshard(stacked):
        """Inverse of :meth:`shard`: ``(n, ...)``."""
        return stacked.reshape((-1,) + tuple(stacked.shape[2:]))

    def psum(self, stacked):
        """Sum over the shards, in mesh order: ``(D, ...)`` → ``(...)``."""
        total = stacked[0]
        for s in range(1, self.n_devices):
            total = total + stacked[s]
        return total

    @staticmethod
    def all_gather(stacked):
        """Every shard's value, stacked along the shard axis: ``(D, ...)``
        (what every shard receives)."""
        return stacked

    def ppermute(self, stacked, shift):
        """Shard ``s`` sends its block to shard ``(s + shift) mod D``: the
        stacked view rolled by ``shift`` along the shard axis."""
        return torch.roll(stacked, shift % self.n_devices, dims=0)

    def axis_index(self, device=None):
        """Each shard's index on the mesh axis, ``arange(D)``."""
        return torch.arange(self.n_devices,
                            device=device if device is not None
                            else self.device)

    def __repr__(self):
        return (f"<ParticleMesh {self.n_devices} devices "
                f"axis={self.axis_name!r}>")


def make_particle_sharding(devices=None, axis_name="particles"):
    """Shorthand: the ``(n,)`` particle sharding over a fresh 1-D mesh."""
    return ParticleMesh(devices, axis_name).particle_sharding


def placement(device, sharding):
    """The device of an entry point given ``device`` (None: the card) and
    ``sharding`` (None, or a particle :class:`MeshSharding`, whose mesh's
    device it is). A device that disagrees with the mesh's raises
    ``ValueError``."""
    if sharding is None:
        return resolve_device(DEFAULT_DEVICE if device is None else device)
    if not isinstance(sharding, MeshSharding):
        raise TypeError(f"sharding must be a MeshSharding of a ParticleMesh "
                        f"(mesh.particle_sharding), not {sharding!r}")
    if not sharding.is_particle_sharding:
        raise ValueError(f"the particle axis takes the mesh's particle "
                         f"sharding (spec ({sharding.mesh.axis_name!r},)), "
                         f"not spec {sharding.spec}")
    mesh_device = sharding.device
    if device is not None and _normalized(device) != mesh_device:
        raise ValueError(f"device {device} disagrees with the mesh's "
                         f"device {mesh_device}")
    return mesh_device


def shard_state(state, sharding):
    """An engine state (``weights`` and ``locations`` fields) laid out by a
    particle ``sharding``: both on the mesh's device, their particle axis
    checked to split into the mesh's equal shards (``ValueError``
    otherwise)."""
    return dataclasses.replace(state, weights=sharding.place(state.weights),
                               locations=sharding.place(state.locations))


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Join a mesh that spans processes. Without a coordinator (one
    process) there is nothing to do and it returns, as the JAX package's
    does for a single host; with one it raises
    :class:`NotImplementedError` (no stand-in pretends to span
    processes)."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    raise NotImplementedError(
        f"a mesh that spans processes is not ported yet ({_LATER}): "
        f"coordinator {coordinator_address!r}, {num_processes} processes, "
        f"process {process_id}")
