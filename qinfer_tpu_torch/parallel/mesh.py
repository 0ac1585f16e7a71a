"""The particle mesh (counterpart of :mod:`qinfer_tpu.parallel.mesh`).

A :class:`ParticleMesh` is a 1-D mesh of D shards. A tensor sharded over
it along the particle axis is D equal contiguous blocks of that axis (the
JAX package's ``P('particles')`` layout): shard s holds rows
``[s·n/D, (s+1)·n/D)``. The mesh's collectives act on the *local stacked
view* ``(L, n/D, ...)`` of such a tensor (:meth:`ParticleMesh.shard`): the
L shards that this process holds, stacked. ``psum`` sums over every shard
of the mesh in mesh order, ``all_gather`` gives every shard the ``(D,
...)`` stack of all shards' values, ``ppermute(shift)`` sends shard s's
block to shard ``(s + shift) mod D``, and ``axis_index`` numbers the local
shards. That is ``shard_map`` written as a batch over the shard axis.

A mesh lies in one of two layouts:

* **One process** holds every shard (L = D), and the shards of one
  ensemble share one device: ``ParticleMesh([dev] * 8)`` is a virtual
  mesh of 8 shards on ``dev``, the counterpart of the JAX package's
  ``--xla_force_host_platform_device_count``. The collectives are local
  arithmetic on the stacked view (``psum`` a loop of adds in mesh order,
  ``all_gather`` the identity, ``ppermute`` a roll). Sharding is a layout
  here: the engine's arithmetic is the unsharded one's, and only
  :class:`~qinfer_tpu_torch.parallel.resample.DistributedLiuWestResampler`
  changes the algorithm, where the caller asks for it. A mesh over
  distinct devices serves trials (``perf_test_scan_batch``); one ensemble
  sharded over distinct devices of one process raises
  :class:`NotImplementedError`.
* **Across processes**, one shard a rank of a ``torch.distributed``
  process group (L = 1), the shard on the rank's device: after
  :func:`initialize_multihost`, ``ParticleMesh()`` spans the world, as the
  JAX package's does after ``jax.distributed.initialize``; or
  :meth:`ParticleMesh.from_process_group`. Each rank holds its own block,
  the engine reduces per-shard partials through the mesh
  (:class:`Reducer`), and the collectives go over the group: ``psum`` an
  ``all_gather`` summed in mesh order on every rank (so every rank holds
  the same bits, and they are the one-process mesh's), ``ppermute`` a
  ``batch_isend_irecv`` pair. Under gloo a CUDA tensor is staged through
  host memory by one copy out and one back (:meth:`ParticleMesh._out`,
  :meth:`ParticleMesh._in`): gloo sends no CUDA tensor. That staging is
  the gloo route, chosen by the backend; under NCCL nothing is staged,
  and each rank holds its own card (one rank a card: NCCL refuses two
  ranks on one).
  ``collective_calls`` counts the group's collectives and
  ``collective_seconds`` their time, by the clock ``collective_timer``
  names: under gloo the host's (after the card's queued work, staging
  included); under NCCL, whose calls only queue work on the card, CUDA
  events on the current stream around each call, summed when the
  seconds are read (one wait for the card then, none a collective).
  While a recording of :mod:`qinfer_tpu_torch.tracing` is on, each
  counted collective is also a span of its kind: ``mesh.all_gather``
  (``psum`` and ``pmax`` too), ``mesh.ppermute`` or ``mesh.barrier``,
  whose parent names the layer that paid for it.

In either layout the engine draws its per-particle values (a keyed
likelihood's noise, a time-dependent model's step, the moves' proposals
and uniforms) from each shard's own stream (:class:`ParticleStreams`,
seeded by the replicated generator's state and the shard index), so a
mesh across processes draws what a one-process mesh of the same D draws;
an unsharded ensemble draws from its generator as it always did.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import time

import torch
import torch.distributed as dist

from .. import tracing
from ..config import DEFAULT_DEVICE, resolve_device

__all__ = ["ParticleMesh", "MeshSharding", "Reducer", "LOCAL",
           "ParticleStreams", "particle_streams", "shard_generators",
           "make_particle_sharding", "initialize_multihost", "placement",
           "reducer_of", "shard_state"]

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
        """The device of this process's shards."""
        return self.mesh.device

    @property
    def is_particle_sharding(self):
        return self.spec == (self.mesh.axis_name,)

    def place(self, tensor):
        """A tensor of the whole ensemble laid out on the mesh: on this
        process's device, its sharded axis checked to divide into D equal
        blocks (``ValueError`` otherwise); on a mesh across processes, the
        rank's own block of it."""
        if self.spec and self.spec[0] is not None:
            self.mesh.check_divides(tensor.shape[0])
            if self.mesh.spans_processes:
                k = tensor.shape[0] // self.mesh.n_devices
                r = self.mesh.rank
                return tensor[r * k:(r + 1) * k].to(self.device).clone()
        return tensor.to(self.device)


class ParticleMesh:
    """A 1-D mesh of shards.

    :param devices: the shards' devices, in mesh order, all held by this
        process. A device may repeat: ``[dev] * 8`` is 8 shards on one
        device. ``None``: the world of the process group when one is up
        (one shard a rank, see :func:`initialize_multihost`), else every
        CUDA device (raising without one, as the entry points do).
    :param str axis_name: the mesh axis (``'particles'``; ``'trials'`` for
        a trial mesh).
    """

    def __init__(self, devices=None, axis_name="particles"):
        if devices is None and dist.is_available() and dist.is_initialized():
            self._join(DEFAULT_DEVICE, axis_name)
            return
        self._start(axis_name, spans_processes=False)
        if devices is None:
            resolve_device(DEFAULT_DEVICE)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = tuple(_normalized(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self._size = len(self.devices)
        self.rank = 0
        self._staged = False

    @classmethod
    def from_process_group(cls, device=None, axis_name="particles"):
        """The mesh of the world's process group, one shard a rank, this
        rank's on ``device`` (default: the card)."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("no process group: call initialize_multihost "
                               "first")
        mesh = cls.__new__(cls)
        mesh._join(DEFAULT_DEVICE if device is None else device, axis_name)
        return mesh

    def _start(self, axis_name, spans_processes):
        self.axis_name = str(axis_name)
        self.spans_processes = spans_processes
        self._events = False
        self.collective_seconds = 0.0
        self.collective_calls = 0

    def _join(self, device, axis_name):
        """Span the world's process group, this rank's shard on
        ``device``."""
        self._start(axis_name, spans_processes=True)
        self.devices = (_normalized(device),)
        self._size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        # gloo sends no CUDA tensor: stage through host memory
        self._staged = (self.backend == "gloo"
                        and self.devices[0].type == "cuda")
        self._events = self.backend == "nccl"
        if self._events and self.devices[0].type != "cuda":
            raise ValueError(f"an NCCL group's shards lie on cards, not on "
                             f"{self.devices[0]}")

    @property
    def n_devices(self):
        """D, the number of shards."""
        return self._size

    @property
    def local_shards(self):
        """L, the shards this process holds: D in one process, 1 on a
        rank."""
        return 1 if self.spans_processes else self._size

    @property
    def shard_indices(self):
        """The indices of this process's shards on the mesh axis (host
        ints)."""
        return [self.rank] if self.spans_processes else list(range(self._size))

    @property
    def device(self):
        """The one device that holds this process's shards of an
        ensemble."""
        first = self.devices[0]
        if any(d != first for d in self.devices):
            raise NotImplementedError(
                f"one ensemble sharded over distinct devices of one process "
                f"({', '.join(sorted({str(d) for d in self.devices}))}) is "
                f"not supported: span processes instead, one shard a rank "
                f"(initialize_multihost); a mesh over distinct devices runs "
                f"trials (perf_test_scan_batch)")
        return first

    def _sharding(self, spec):
        self.device  # one ensemble's local shards share one device
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
        """The local stacked view ``(L, n/D, ...)`` of this process's part
        of a tensor whose first axis is sharded over the mesh."""
        if tensor.shape[0] % self.local_shards:
            self.check_divides(tensor.shape[0])
        return tensor.reshape((self.local_shards, -1)
                              + tuple(tensor.shape[1:]))

    @staticmethod
    def unshard(stacked):
        """Inverse of :meth:`shard`: ``(L·n/D, ...)``."""
        return stacked.reshape((-1,) + tuple(stacked.shape[2:]))

    @property
    def collective_timer(self):
        """The clock of ``collective_seconds``."""
        if self._events:
            return "CUDA events on the current stream"
        if self._staged:
            return ("host clock after a device sync (staged through host "
                    "memory)")
        return "host clock"

    @property
    def collective_seconds(self):
        """The time of the group's collectives so far (see the module);
        under NCCL, reading it waits for the last collective's end."""
        if self._pending:
            self._pending[-1][1].synchronize()
            self._fold(len(self._pending))
        return self._seconds

    @collective_seconds.setter
    def collective_seconds(self, value):
        self._seconds = float(value)
        self._pending = []

    def _fold(self, k):
        """Add the first ``k`` timed collectives (their end events done)
        to the seconds and drop their events."""
        self._seconds += sum(a.elapsed_time(b)
                             for a, b in self._pending[:k]) / 1e3
        del self._pending[:k]

    @contextlib.contextmanager
    def _collective(self, span):
        """Count one collective of the group and its time: under NCCL a
        pair of CUDA events on the current stream around it, summed by
        ``collective_seconds`` (the pairs the card has passed are summed
        here first, with no wait, so few stay pending); else the host's
        wall time, staging included, after the card's queued work (not
        counted). The span ``span`` (``mesh.<kind>``, :mod:`..tracing`)
        covers what the counter times, one a collective counted."""
        if self._events:
            done = 0
            while (done < len(self._pending)
                   and self._pending[done][1].query()):
                done += 1
            self._fold(done)
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                with tracing.span(span):
                    yield
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self._pending.append((start, end))
                self.collective_calls += 1
            return
        if self._staged:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            with tracing.span(span):
                yield
        finally:
            self._seconds += time.perf_counter() - t0
            self.collective_calls += 1

    def _out(self, tensor):
        """A block as the group's backend sends it: staged to host memory
        under gloo for a CUDA tensor, else as it is."""
        tensor = tensor.contiguous()
        return tensor.cpu() if self._staged else tensor

    def _in(self, tensor):
        """A received block back on this rank's device."""
        return tensor.to(self.device) if self._staged else tensor

    def all_gather(self, stacked):
        """Every shard's value, stacked in mesh order along the shard
        axis: ``(L, ...)`` → ``(D, ...)`` (what every shard receives)."""
        if not self.spans_processes:
            return stacked
        with self._collective("mesh.all_gather"):
            local = self._out(stacked[0])
            parts = [torch.empty_like(local) for _ in range(self._size)]
            dist.all_gather(parts, local)
            return self._in(torch.stack(parts))

    def psum(self, stacked):
        """Sum over every shard, in mesh order: ``(L, ...)`` → ``(...)``,
        the same bits on every rank and in one process."""
        every = self.all_gather(stacked)
        total = every[0]
        for s in range(1, self._size):
            total = total + every[s]
        return total

    def pmax(self, stacked):
        """Elementwise maximum over every shard: ``(L, ...)`` → ``(...)``."""
        return torch.amax(self.all_gather(stacked), dim=0)

    def ppermute(self, stacked, shift):
        """Shard ``s`` sends its block to shard ``(s + shift) mod D`` and
        receives the block of shard ``(s − shift) mod D``: ``(L, ...)`` →
        ``(L, ...)``; in one process, the stacked view rolled by ``shift``
        along the shard axis."""
        shift %= self._size
        if not self.spans_processes:
            return torch.roll(stacked, shift, dims=0)
        if shift == 0:
            return stacked
        with self._collective("mesh.ppermute"):
            send = self._out(stacked[0])
            recv = torch.empty_like(send)
            D, r = self._size, self.rank
            ops = [dist.P2POp(dist.isend, send, (r + shift) % D),
                   dist.P2POp(dist.irecv, recv, (r - shift) % D)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return self._in(recv)[None]

    def barrier(self):
        """Wait until every rank has reached this point (a no-op in one
        process)."""
        if self.spans_processes:
            with self._collective("mesh.barrier"):
                if self.backend == "nccl":
                    dist.barrier(device_ids=[self.device.index])
                else:
                    dist.barrier()

    def axis_index(self, device=None):
        """The local shards' indices on the mesh axis: ``arange(D)`` in one
        process, ``[rank]`` on a rank."""
        device = device if device is not None else self.device
        if self.spans_processes:
            return torch.full((1,), self.rank, dtype=torch.int64,
                              device=device)
        return torch.arange(self._size, device=device)

    def __repr__(self):
        where = (f" ranks, rank {self.rank}, {self.backend}"
                 if self.spans_processes else " devices")
        return (f"<ParticleMesh {self.n_devices}{where} "
                f"axis={self.axis_name!r}>")


class Reducer:
    """The engine's reductions over the particle axis, from this process's
    partials. Unsharded, and on a mesh held by one process, a partial is
    already the whole (the plain ``torch.sum`` / ``torch.max`` over the
    whole tensor, to the bit): the reducer returns it as it is. On a mesh
    across processes it is the rank's partial, reduced over the ranks by
    the mesh's ``psum`` or ``pmax``.

    ``n_shards`` scales a local particle count to the ensemble's."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else mesh.n_devices

    def sum(self, partial):
        return partial if self.mesh is None else self.mesh.psum(partial[None])

    def max(self, partial):
        return partial if self.mesh is None else self.mesh.pmax(partial[None])

    def all(self, flags):
        """Whether every flag of every shard is set (a host bool)."""
        if self.mesh is None:
            return bool(flags.all())
        return not bool(self.sum((~flags).sum().to(torch.int32)))

    def gather(self, local):
        """The whole ensemble's tensor from this process's rows of it
        (particle axis first): the rows themselves, or every rank's block
        in mesh order (one ``all_gather``)."""
        if self.mesh is None:
            return local
        return self.mesh.unshard(self.mesh.all_gather(local[None]))


#: the reducer of an unsharded ensemble, or of a mesh in one process
LOCAL = Reducer()


def reducer_of(sharding):
    """The :class:`Reducer` of an ensemble laid out by ``sharding``
    (``None`` or a :class:`MeshSharding`)."""
    if sharding is not None and sharding.mesh.spans_processes:
        return Reducer(sharding.mesh)
    return LOCAL


def shard_generators(generator, mesh, device):
    """One generator for each of this process's shards: shard s's is
    seeded from ``generator``'s state (the same on every shard: it draws
    only replicated values) and s, as the JAX package folds the shard
    index into its key, so shard s draws the same values whichever
    process holds it. Then ``generator`` draws one value, so that the next
    call seeds other streams. Reading the state copies nothing from the
    card."""
    state = generator.get_state().numpy().tobytes()
    gens = []
    for s in mesh.shard_indices:
        word = hashlib.blake2b(state + s.to_bytes(8, "little"),
                               digest_size=8).digest()
        g = torch.Generator(device=device)
        g.manual_seed(int.from_bytes(word, "little") >> 1)
        gens.append(g)
    torch.rand((), generator=generator, device=device)
    return gens


class ParticleStreams:
    """The per-particle random streams of an ensemble sharded over a
    mesh: one generator for each shard this process holds
    (:func:`shard_generators`), so a per-particle draw of shard s is the
    same whichever process holds it, and a mesh across processes draws
    what a one-process mesh of the same D draws. The engine's
    per-particle draws (a keyed likelihood's noise, a time-dependent
    model's step, the moves' proposals and uniforms) go through
    :meth:`map`; replicated draws stay on the caller's generator.

    :attr reducer: the :class:`Reducer` of the ensemble's sums (a keyed
        likelihood's global stopping rule reads it).
    """

    def __init__(self, generator, mesh):
        self.mesh = mesh
        self.generators = shard_generators(generator, mesh, generator.device)
        self.reducer = reducer_of(mesh.particle_sharding)

    def map(self, fn, *tensors, dim=0, out_dim=None):
        """``fn(g_s, *blocks_s)`` for each local shard s, on its blocks of
        ``tensors`` (each split into L equal blocks along ``dim``, the
        particle axis), concatenated in shard order along ``out_dim``
        (default ``dim``), the particle axis of ``fn``'s result."""
        L = len(self.generators)
        if L == 1:
            return fn(self.generators[0], *tensors)
        blocks = [t.chunk(L, dim) for t in tensors]
        return torch.cat([fn(g, *(b[s] for b in blocks))
                          for s, g in enumerate(self.generators)],
                         dim if out_dim is None else out_dim)


def particle_streams(generator, mesh):
    """Where an ensemble's per-particle draws come from: ``generator``
    itself for an unsharded ensemble (``mesh`` None), so its bits do not
    change; else fresh :class:`ParticleStreams` of the mesh's local
    shards, seeded from ``generator`` (which draws one value)."""
    return generator if mesh is None else ParticleStreams(generator, mesh)


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
    """An engine state of the whole ensemble (``weights`` and
    ``locations`` fields) laid out by a particle ``sharding``
    (:meth:`MeshSharding.place`: on the mesh's device, its particle axis
    checked to split into the mesh's equal shards, ``ValueError``
    otherwise; the rank's own rows on a mesh across processes)."""
    return dataclasses.replace(state, weights=sharding.place(state.weights),
                               locations=sharding.place(state.locations))


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, backend="gloo"):
    """Join a mesh that spans processes (the ipyparallel controller's
    replacement): ``torch.distributed.init_process_group`` over
    ``num_processes`` ranks, this process rank ``process_id``, with the
    rendezvous at ``coordinator_address`` (``host:port``, read as
    ``tcp://host:port``, or a ``tcp://`` or ``file://`` URL; ``None``
    reads the ``env://`` variables). Afterwards ``ParticleMesh()`` spans
    the world, one shard a rank, this rank's on the card;
    :meth:`ParticleMesh.from_process_group` names another device (a CPU
    rank's).

    Without a coordinator and for one process there is nothing to do and
    it returns, as the JAX package's does for a single host. A second call
    on a group that is up returns when it names the group's size and this
    rank, and raises ``ValueError`` when it does not. Any other failure
    (an unreachable coordinator, a rank outside the world) propagates:
    a wrong configuration never becomes a run in one process.

    :param str backend: ``'gloo'`` (the CPU, and a card through host
        memory) or ``'nccl'`` (cards only, one rank a card: make the
        rank's card the current device first, ``torch.cuda.set_device``).
        Under NCCL the current card is bound to the group (``device_id``,
        where the installed torch takes it), whose communicator then
        starts at once, with a barrier over the ranks before any
        point-to-point exchange.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not "
                         f"{backend!r}")
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if ((num_processes is not None and num_processes != size)
                or (process_id is not None and process_id != rank)):
            raise ValueError(
                f"a process group of {size} ranks is up, this process rank "
                f"{rank}: not {num_processes} processes, process "
                f"{process_id}")
        return
    url = coordinator_address
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    opts = {}
    if backend == "nccl":
        card = _normalized("cuda")
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            opts["device_id"] = card
    dist.init_process_group(backend=backend, init_method=url,
                            world_size=-1 if num_processes is None
                            else int(num_processes),
                            rank=-1 if process_id is None
                            else int(process_id), **opts)
    if backend == "nccl":
        dist.barrier(device_ids=[card.index])
