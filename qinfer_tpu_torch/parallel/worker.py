"""One rank of a particle mesh across processes (the port's counterpart of
the JAX package's ``tests/_multiprocess_worker.py``).

Start one process a rank, all with the same arguments but ``--rank``::

    python -m qinfer_tpu_torch.parallel.worker --rank R --world W \\
        --init-method file:///tmp/store --tasks jax,precession \\
        [--backend gloo|nccl] [--cpu]

The ranks join a process group (:func:`initialize_multihost`; the
``--init-method`` is a ``tcp://host:port`` or ``file://`` rendezvous) of
the ``--backend`` (gloo by default), build ``ParticleMesh()`` over the
world, one shard a rank, and run the tasks in order, each printing one
line ``RESULT {json}`` (a task that runs twice, as ``precession`` does by
the ring and by the butterfly, prints two). Every number in a line is the
same on every rank unless its key says ``local``; ``collective_timer``
names the clock of the lines' collective seconds
(``ParticleMesh.collective_timer``). A rank runs on card ``r mod C`` of
its host's C cards (:func:`card_of`), r its rank on that host
(:func:`host_slot`: ``LOCAL_RANK`` where the launcher sets it, else the
world's rank), made its current device before it joins the group: under
gloo each collective is staged through host memory, and ranks beyond C
share cards; NCCL takes one card a rank, so more ranks on a host than C
raise ``ValueError`` naming both counts, and nothing runs (nor drops to
gloo). The ranks refuse to run without a card unless ``--cpu`` asks for
the CPU (gloo only).

Tasks:

* ``card``: the rank's card (``local_card``, :func:`card_info`): its
  name, PCI bus id and UUID.

* ``jax``: the JAX worker's computation: a uniform prior ensemble of
  4096 particles from ``numpy.random.default_rng(0)``, one
  update of ``SimplePrecessionModel`` at t = 4.3 with outcome 1 (the ESS
  gate off), one forced ``DistributedLiuWestResampler(exchange='ring')``
  resample from a generator seeded 2, and the posterior moments.
* ``exchange``: the block exchange and the two-level fill, by the ring
  and by the butterfly, of a NumPy ensemble (``--particles`` x 2, seed
  ``--seed``) at fixed offsets, and one update of that ensemble; the
  rank's own blocks (``local_*``).
* ``precession``: ``perf_test_scan`` with ``AcceleratedPrecessionModel``
  (kernels K1 and K2 a step, K3 a resample), ``--particles`` in all x
  ``--steps``, truth ω = 0.7, seed ``--seed``, and
  ``DistributedLiuWestResampler`` by the ring and then by the butterfly
  (one line each), after a warm-up run of 8 steps; each run's wall,
  particle-updates/s, kernel launches on this rank, and the number and
  time of the mesh's collectives (by ``collective_timer``'s clock). With
  ``--record DIR``, each rank then writes ``DIR/rank{R}.pt``: the inputs
  of the ring run's last K1 call (ω, w, t, outcome), those of its first
  resample (the generator's state, the rank's weights and particles) and
  that resample's fill, replayed from them (u₂, the received blocks, and K3's
  counts, first slots and output), and each step's PGH draw until then
  (the generator's state and the rank's ensemble, :func:`recorders`),
  for a caller to hold the kernels against their plain versions at the
  rank's shapes, and the resample and the designs against a run in one
  process (:func:`replay_pgh`).
* ``config5``: ``expdesign_bench.run_bench`` (BASELINE config 5) at
  ``--config5 N,STEPS,CANDIDATES`` on the mesh, with its per-step
  record.
* ``collectives``: the mesh's four collectives on a fixed input,
  ``initialize_multihost`` called again, ``ParticleMesh()`` (the world on
  the card: it refuses the CPU), an ``SMCUpdater`` of 10 particles
  a rank (seed 0) after one update of ``SimplePrecessionModel`` at t =
  4.3 with outcome 1: its estimators, design scores, a PGH proposal and
  five draws; a checkpoint saved and loaded back; and the refusals (a
  particle count the world does not divide; an estimator that reads the
  cloud on the host; a checkpoint of another mesh size).
* ``runs``: the runs of :mod:`.runs` named by ``--runs
  NAME:PARTICLES:STEPS[:SAVE_AT],...``, one RESULT line each with its
  record (:func:`.runs.drive`), its wall, its kernel launches on this
  rank and its collectives, and the run's own wall and collectives
  (``local_run_s``, ``run_collective_calls``,
  ``local_run_collective_s``: those less the record's reads). A run
  with ``SAVE_AT`` saves its updater after that step to ``--checkpoint
  DIR``/NAME (one block a rank and a manifest); with ``--resume`` it
  instead starts from that checkpoint, loaded into an updater of another
  seed, and runs the steps after it.
  With ``--record DIR`` the ``flagship`` run writes ``DIR/flagship_
  rank{R}.pt``: its first resample's fill replayed from the kept
  generator state and particles (K3's inputs and output, as the
  ``precession`` task's record) and the particles its first strict
  projection took (K5's input, embedded by the caller).
* ``trials``: ``perf_test_scan_batch`` with ``AcceleratedPrecessionModel``
  at ``--trials T,PARTICLES,STEPS`` (seed ``--seed``) on the trial mesh
  across the ranks: rank r runs its block of trials, and every rank
  returns every trial's record; the line holds a SHA-1 of each record
  tensor's bytes, the estimates and the launches.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
import types

import numpy as np
import torch

from ..config import resolve_device
from . import runs
from .mesh import ParticleMesh, initialize_multihost, reducer_of, shard_state

TASKS = ("card", "jax", "exchange", "precession", "config5", "collectives",
         "runs", "trials")


def card_of(rank, n_cards):
    """The card of the host's rank ``rank`` on a host of ``n_cards`` cards
    (one rank a card while there are cards enough)."""
    return rank % n_cards


def host_slot(rank, world, environ=os.environ):
    """``(rank on this host, ranks on this host)``: ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` where the launcher sets them (``torchrun``
    does), else the world's, one host."""
    return (int(environ.get("LOCAL_RANK", rank)),
            int(environ.get("LOCAL_WORLD_SIZE", world)))


def card_info(device):
    """``{name, pci_bus_id, uuid}`` of a card, from CUDA's device
    properties."""
    props = torch.cuda.get_device_properties(device)
    return {"name": props.name,
            "pci_bus_id": f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}"
                          f":{props.pci_device_id:02X}.0",
            "uuid": str(props.uuid).removeprefix("GPU-")}


def _counted():
    """Every kernel wrapper, by kernel name (each counts its launches)."""
    from ..ops import jacobi as jac
    from ..ops import precession as prec
    from ..ops import streaming_resample as sr

    return {"fused_precession_update": prec.fused_precession_update,
            "precession_pr0": prec.precession_pr0,
            "streaming_resample_locations": sr.streaming_resample_locations,
            "jacobi_project_lanes": jac.jacobi_project_lanes,
            "jacobi_project_lanes_looped": jac.jacobi_project_lanes_looped,
            "jacobi_eigh_lanes": jac.jacobi_eigh_lanes}


def _zero_counts():
    for fn in _counted().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _counted().items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prior_state(mesh, n, seed, d=1):
    """A uniform prior ensemble of ``n`` rows from a NumPy seed, with
    uniform weights, laid out on the mesh (the rank's rows)."""
    from ..smc import SMCState

    x = np.random.default_rng(seed).uniform(size=(n, d)).astype(np.float32)
    return shard_state(SMCState.initial(torch.from_numpy(x)),
                       mesh.particle_sharding)


def _one_update(mesh, state):
    """``SimplePrecessionModel``'s update at t = 4.3, outcome 1, the ESS
    gate off: ``(state, log_norm)``."""
    from ..resamplers import LiuWestResampler
    from ..smc import _update_step
    from ..test_models import SimplePrecessionModel

    dev = mesh.device
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    state, log_norm, _ = _update_step(
        SimplePrecessionModel(), LiuWestResampler(a=0.98), state,
        torch.ones((1,), dtype=torch.int32, device=dev),
        {"t": torch.full((1,), 4.3, device=dev)}, 0.0, 1e-10, g,
        reducer=reducer_of(mesh.particle_sharding))
    return state, log_norm


def task_card(mesh, args):
    yield {"local_card": (card_info(mesh.device)
                          if mesh.device.type == "cuda" else None)}


def task_jax(mesh, args):
    from ..test_models import SimplePrecessionModel
    from .resample import DistributedLiuWestResampler

    red = reducer_of(mesh.particle_sharding)
    n = 4096
    state, log_norm = _one_update(mesh, _prior_state(mesh, n, 0))
    post_mean = red.sum(state.weights @ state.locations)
    g = torch.Generator(device=mesh.device)
    g.manual_seed(2)
    rs = DistributedLiuWestResampler(mesh, a=0.98, exchange="ring")
    w2, x2 = rs(SimplePrecessionModel(), g, state.weights, state.locations)
    mu = red.sum(w2 @ x2)
    xc = x2 - mu[None, :]
    cov = red.sum((xc * w2[:, None]).T @ xc)
    yield {"log_norm": log_norm, "post_update_mean": post_mean.tolist(),
           "mean": mu.tolist(), "cov": cov.tolist(),
           "weights_uniform": red.all(torch.abs(w2 - 1.0 / n) <= 1e-9),
           "local_rows": int(w2.shape[0])}


def task_exchange(mesh, args):
    from .resample import exchange_blocks, two_level_fill

    n, D = args.particles, mesh.n_devices
    rng = np.random.default_rng(args.seed)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    w = (np.exp(-((np.arange(n) - n / 5) / (n / 5)) ** 2)
         * rng.random(n)).astype(np.float32)
    w /= w.sum()
    u1 = torch.tensor(np.float32(0.37), device=mesh.device)
    u2 = torch.from_numpy(rng.uniform(0.0, 0.9, size=D).astype(np.float32))
    u2 = u2[mesh.rank:mesh.rank + 1].to(mesh.device)
    sharding = mesh.particle_sharding
    wv = mesh.shard(sharding.place(torch.from_numpy(w)))
    xv = mesh.shard(sharding.place(torch.from_numpy(x)))
    out = {}
    for exchange in ("ring", "butterfly"):
        recv_w, recv_x = exchange_blocks(mesh, u1, wv, xv, exchange)
        fill = two_level_fill(mesh, u1, u2, wv, xv, exchange)
        out[exchange] = {"local_w": recv_w[0].tolist(),
                         "local_x": recv_x[0].tolist(),
                         "local_fill": fill[0].tolist()}
    state, log_norm = _one_update(mesh, _prior_state(mesh, n, args.seed))
    out["update"] = {"log_norm": log_norm,
                     "local_weights": state.weights.tolist()}
    yield out


#: the steps whose PGH draws :func:`recorders` keeps, at most
KEPT_DESIGNS = 16


def recorders(mesh, steps, exchange):
    """An ``AcceleratedPrecessionModel`` that keeps each step's design t
    (``ts``, on the device) and the inputs of its K1 call at the last of
    ``steps`` steps, and a ``DistributedLiuWestResampler(a=0.98)`` that
    keeps those of its first call: the generator's state, the weights and
    the particles. The model's ``heuristic`` is a ``heuristic_factory``
    of ``PGH`` that keeps what each step's draw starts from until that
    first call (at most ``KEPT_DESIGNS`` steps): the generator's state,
    the weights and the particles (``designs``; :func:`replay_pgh`)."""
    from ..heuristics import PGH
    from ..ops.accelerated import AcceleratedPrecessionModel
    from .resample import DistributedLiuWestResampler

    class Heuristic(PGH):
        def propose(self, generator, weights, locations, idx_exp):
            if rs.first is None and len(model.designs) < KEPT_DESIGNS:
                model.designs.append((generator.get_state(), weights.clone(),
                                      locations.clone()))
            return super().propose(generator, weights, locations, idx_exp)

    class Model(AcceleratedPrecessionModel):
        calls, last = 0, None
        heuristic = Heuristic

        def __init__(self):
            super().__init__()
            self.ts, self.designs = [], []

        def fused_reweight(self, weights, locations, outcome, expparams):
            self.calls += 1
            self.ts.append(expparams["t"].reshape(-1)[:1])
            if self.calls == steps:
                self.last = (locations[:, 0].clone(), weights.clone(),
                             float(expparams["t"].reshape(-1)[0]),
                             int(outcome.reshape(-1)[0]))
            return super().fused_reweight(weights, locations, outcome,
                                          expparams)

    class Resampler(DistributedLiuWestResampler):
        first = None

        def call_with_diagnostics(self, model, generator, w, x):
            if self.first is None:
                self.first = (generator.get_state(), w.clone(), x.clone())
            return super().call_with_diagnostics(model, generator, w, x)

    model, rs = Model(), Resampler(mesh, a=0.98, exchange=exchange)
    return model, rs


class _Ranks:
    """What :func:`~qinfer_tpu_torch.heuristics.mesh_inverse_cdf` sees of
    its mesh, as rank ``rank`` of the ranks whose blocks' totals are
    ``totals`` (D,): their first all-gather; the second, of the owners'
    rows, is not read here."""

    def __init__(self, totals, rank):
        self.totals, self.rank = totals, rank
        self.n_devices = totals.shape[0]
        self.gathers = 0

    def all_gather(self, stacked):
        self.gathers += 1
        if self.gathers == 1:
            return self.totals
        return stacked.expand((self.n_devices,) + tuple(stacked.shape[1:]))


def replay_pgh(model, state, weights, locations):
    """The experiment ``PGH`` proposes from the generator state ``state``
    over an ensemble held as the blocks of its shards, ``weights`` [(n/D,)]
    and ``locations`` [(n/D, d)], in one process: one block is a
    one-process run's (``heuristics.categorical_inverse_cdf``), D blocks
    the ranks' of a mesh across processes (``heuristics.mesh_inverse_cdf``
    on each block, as its rank runs it). ``(t, (i, j))``: the design, and
    the two draws' indices in the whole ensemble."""
    from ..config import EPS
    from ..heuristics import PGH, categorical_inverse_cdf, mesh_inverse_cdf
    from ..utils import cumsum_last

    dev = weights[0].device
    g = torch.Generator(device=dev)
    g.set_state(state)
    ps = [torch.clamp_min(w, EPS) for w in weights]
    picks = []
    for _ in range(2):
        if len(ps) == 1:
            i = categorical_inverse_cdf(g, ps[0])
            picks.append((0, i))
            ps[0] = ps[0].scatter(0, i, 0.0)
            continue
        totals = torch.cat([cumsum_last(p)[-1:] for p in ps])
        drawn = g.get_state()
        shard = int(mesh_inverse_cdf(g, ps[0], locations[0],
                                     _Ranks(totals, 0))[1])
        g.set_state(drawn)  # the owner's draw, from the same uniform
        _, _, i, _ = mesh_inverse_cdf(g, ps[shard], locations[shard],
                                      _Ranks(totals, shard))
        picks.append((shard, i))
        ps[shard] = ps[shard].scatter(0, i, 0.0)
    x1, x2 = (locations[s][i] for s, i in picks)
    eps = PGH(types.SimpleNamespace(model=model))._fields(x1, x2)
    n_block = weights[0].shape[0]
    return (float(eps["t"].reshape(-1)[0]),
            tuple(s * n_block + int(i) for s, i in picks))


def _record_kernel_inputs(mesh, model, rs, path):
    """Write the kept K1 inputs and the replayed first fill (the block
    exchange again from the kept generator state, then the fill's one K3
    launch) to ``path``, on the host."""
    from ..resamplers import counting_locations_batch_from_u
    from .resample import exchange_blocks

    gen_state, w, x = rs.first
    g = torch.Generator(device=mesh.device)
    g.set_state(gen_state)
    u1, u2, wv, xv, _ = rs.fill_inputs(g, w, x)
    recv_w, recv_x = exchange_blocks(mesh, u1, wv, xv, rs.exchange)
    x_anc, m, starts = counting_locations_batch_from_u(u2, recv_w, recv_x)
    omega, k1_w, t, outcome = model.last
    torch.save({"k1": (omega.cpu(), k1_w.cpu(), t, outcome),
                "resample": (gen_state, w.cpu(), x.cpu()),
                "designs": [(s, dw.cpu(), dx.cpu())
                            for s, dw, dx in model.designs],
                "fill": tuple(v.cpu() for v in (u2, recv_w, recv_x, m,
                                                starts, x_anc))}, path)


def task_precession(mesh, args):
    from ..distributions import UniformDistribution
    from ..ops.accelerated import AcceleratedPrecessionModel
    from ..perf_testing import perf_test_scan
    from .resample import DistributedLiuWestResampler

    prior = UniformDistribution([[0.0, 1.0]])
    n, steps, dev = args.particles, args.steps, mesh.device

    def run(model, resampler, n_steps, heuristic=None):
        return perf_test_scan(
            model, n, prior, n_steps, true_mps=[[0.7]], seed=args.seed,
            resampler=resampler, sharding=mesh.particle_sharding,
            device=dev, heuristic_factory=heuristic)

    run(AcceleratedPrecessionModel(), DistributedLiuWestResampler(
        mesh, a=0.98, exchange="ring"), 8)  # warm-up
    finals = {}
    for exchange in ("ring", "butterfly"):
        model, rs = recorders(mesh, steps, exchange)
        if exchange == "ring":
            kept = (model, rs)
        _zero_counts()
        mesh.collective_seconds, mesh.collective_calls = 0.0, 0
        _sync(dev)
        t0 = time.perf_counter()
        u, rec = run(model, rs, steps, model.heuristic)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = _counts()
        finals[exchange] = u.state
        est = float(rec["est"][-1, 0])
        result = {
            "exchange": exchange, "particles": n, "steps": steps,
            "local_rows": int(u.particle_weights.shape[0]),
            "est": est, "resamples": u.resample_count,
            "log_evidence": float(u.state.log_total_likelihood),
            "min_n_ess": float(u.state.min_n_ess),
            "est_record": rec["est"][:, 0].tolist(),
            "ess_record": rec["ess"].tolist(),
            "t_record": torch.cat(model.ts).tolist(),
            "posterior_sd": float(u.est_covariance_mtx()[0, 0]) ** 0.5,
            "finite": bool(torch.isfinite(u.particle_weights).all()
                           and torch.isfinite(u.particle_locations).all()),
            "wall_s": wall, "updates_per_s": n * steps / wall,
            "local_launches": launches,
            "local_collective_s": mesh.collective_seconds,
            "collective_calls": mesh.collective_calls}
        if exchange == "butterfly":
            a, b = finals["ring"], finals["butterfly"]
            result["local_ring_equals_butterfly"] = all(
                torch.equal(getattr(a, f), getattr(b, f))
                for f in ("weights", "locations", "log_total_likelihood",
                          "min_n_ess"))
        yield result
    if args.record:
        _record_kernel_inputs(mesh, *kept,
                              f"{args.record}/rank{mesh.rank}.pt")


def task_config5(mesh, args):
    from .. import expdesign_bench as eb

    n, steps, cand = args.config5
    _zero_counts()
    mesh.collective_seconds, mesh.collective_calls = 0.0, 0
    r = eb.run_bench(n, steps, cand, 0, mesh.device, mesh=mesh, record=True)
    state = r.pop("state")
    r["local_rows"] = int(state.weights.shape[0])
    r["local_launches"] = _counts()
    # the warm-up run and the timed run both count
    r["local_collective_s"] = mesh.collective_seconds
    r["collective_calls"] = mesh.collective_calls
    yield r


def fixed_blocks(mesh):
    """The local stacked view of a fixed (10 D, 2) tensor on ``mesh``:
    shard s's block is rows [10 s, 10 s + 10)."""
    rows = torch.arange(20, dtype=torch.float32,
                        device=mesh.device).reshape(10, 2)
    return torch.stack([rows + 100.0 * s for s in mesh.shard_indices])


def engine_values(mesh):
    """An ``SMCUpdater`` of 10 particles a shard (seed 0) on ``mesh``
    after one update of ``SimplePrecessionModel`` at t = 4.3 with outcome
    1, and its values: estimators, design scores, a PGH proposal and five
    draws. ``(updater, values)``."""
    from ..distributions import UniformDistribution
    from ..heuristics import PGH
    from ..smc import SMCUpdater
    from ..test_models import SimplePrecessionModel

    u = SMCUpdater(SimplePrecessionModel(), 10 * mesh.n_devices,
                   UniformDistribution([[0.0, 1.0]]),
                   sharding=mesh.particle_sharding)
    u.update(torch.tensor(1), {"t": torch.tensor([4.3])},
             check_for_resample=False)
    cand = {"t": torch.tensor([0.5, 1.0, 2.0, 4.0])}
    return u, {
        "mean": u.est_mean().tolist(),
        "cov": u.est_covariance_mtx().tolist(),
        "n_ess": u.n_ess, "entropy": float(u.est_entropy()),
        "log_total_likelihood": u.log_total_likelihood,
        "eig": u.expected_information_gain(cand).tolist(),
        "risk": u.bayes_risk(cand).tolist(),
        "pgh_t": float(PGH(u)()["t"][0]),
        "sample": u.sample(5).tolist()}


def task_collectives(mesh, args):
    from ..checkpoint import load_updater, save_updater
    from ..distributions import UniformDistribution
    from ..smc import SMCUpdater
    from ..test_models import SimplePrecessionModel

    D, r = mesh.n_devices, mesh.rank
    block = fixed_blocks(mesh)
    try:
        implicit = ParticleMesh()
        implicit = [implicit.n_devices, implicit.rank == r,
                    str(implicit.device)]
    except RuntimeError as exc:
        implicit = str(exc)
    out = {"n_devices": D, "spans_processes": mesh.spans_processes,
           "local_implicit_mesh": implicit,
           "local_axis_index": mesh.axis_index().tolist(),
           "psum": mesh.psum(block).tolist(),
           "all_gather": mesh.all_gather(block).tolist(),
           "local_ppermute": {str(k): mesh.ppermute(block, k)[0].tolist()
                              for k in range(-1, D + 1)}}
    initialize_multihost(args.init_method, D, r)  # a second call returns
    try:
        initialize_multihost(args.init_method, D + 1, r)
        out["local_second_call"] = "returned"
    except ValueError as exc:
        out["local_second_call"] = str(exc)
    model, prior = SimplePrecessionModel(), UniformDistribution([[0.0, 1.0]])
    try:
        SMCUpdater(model, 10 * D + 1, prior, sharding=mesh.particle_sharding)
        out["indivisible"] = "accepted"
    except ValueError as exc:
        out["indivisible"] = str(exc)
    u, out["engine"] = engine_values(mesh)
    out["updater_local_rows"] = int(u.particle_weights.shape[0])
    try:
        u.est_credible_region()
        out["host_estimator"] = "ran"
    except NotImplementedError as exc:
        out["host_estimator"] = str(exc)
    # every rank writes to the same directory (rank 0 picks it)
    tmp = [tempfile.mkdtemp() if r == 0 else None]
    torch.distributed.broadcast_object_list(tmp, src=0)
    path = f"{tmp[0]}/checkpoint"
    save_updater(path, u)
    v = SMCUpdater(model, 10 * D, prior, seed=1,
                   sharding=mesh.particle_sharding)
    load_updater(path, v)
    out["reloaded"] = (torch.equal(u.particle_weights, v.particle_weights)
                       and torch.equal(u.particle_locations,
                                       v.particle_locations)
                       and u.n_particles == v.n_particles
                       and torch.equal(u.generator.get_state(),
                                       v.generator.get_state()))
    manifest = dict(np.load(path + ".npz"))
    mesh.barrier()
    if r == 0:
        np.savez(f"{tmp[0]}/other.npz", **dict(
            manifest, __process_shards=np.int64(D - 1)))
    mesh.barrier()
    try:
        load_updater(f"{tmp[0]}/other", v)
        out["other_size"] = "loaded"
    except ValueError as exc:
        out["other_size"] = str(exc)
    mesh.barrier()
    if r == 0:
        shutil.rmtree(tmp[0])
    yield out


def _run_specs(text):
    """``NAME:PARTICLES:STEPS[:SAVE_AT],...`` as tuples."""
    specs = []
    for item in filter(None, text.split(",")):
        name, n, steps, *save = item.split(":")
        specs.append((name, int(n), int(steps),
                      int(save[0]) if save else None))
    return specs


def _keep_first_projection(run):
    """Keep the ``flagship`` run's first resample's inputs (the generator
    state, the weights, the particles) and the particles its strict
    projection then takes (K5's input, before the embedding): a dict the
    run fills."""
    kept = {}
    rs, tomo = run.updater.resampler, run.tomography
    call, canonicalize = rs.call_with_diagnostics, tomo.canonicalize

    def keep_call(model, generator, w, x):
        if "resample" not in kept:
            kept["resample"] = (generator.get_state(), w.clone(), x.clone())
            kept["projections"] = tomo.projection_count
        return call(model, generator, w, x)

    def keep_canonicalize(x):
        if "resample" in kept and "k5" not in kept:
            kept["k5"] = x.clone()
            out = canonicalize(x)
            kept["projected"] = tomo.projection_count > kept["projections"]
            return out
        return canonicalize(x)

    rs.call_with_diagnostics = keep_call
    tomo.canonicalize = keep_canonicalize
    return kept


def _record_flagship(mesh, rs, kept, path):
    """Write the kept K5 input and the first fill, replayed from the kept
    generator state (the block exchange, then the fill's one K3 launch),
    to ``path`` on the host."""
    from ..resamplers import counting_locations_batch_from_u
    from .resample import exchange_blocks

    gen_state, w, x = kept["resample"]
    g = torch.Generator(device=mesh.device)
    g.set_state(gen_state)
    u1, u2, wv, xv, _ = rs.fill_inputs(g, w, x)
    recv_w, recv_x = exchange_blocks(mesh, u1, wv, xv, rs.exchange)
    x_anc, m, starts = counting_locations_batch_from_u(u2, recv_w, recv_x)
    torch.save({"k5": kept["k5"].cpu(), "projected": kept["projected"],
                "fill": tuple(v.cpu() for v in (u2, recv_w, recv_x, m,
                                                starts, x_anc))}, path)


def task_runs(mesh, args):
    from ..checkpoint import load_updater

    dev = mesh.device
    for name, n, steps, save_at in _run_specs(args.runs):
        path = f"{args.checkpoint}/{name}" if save_at is not None else None
        resume = args.resume and save_at is not None
        # the launches count the prior's draw (K6 in the flagship's)
        _zero_counts()
        run = runs.make_run(mesh, name, n, steps,
                            seed=runs.SEED + 1 if resume else runs.SEED)
        kept = (_keep_first_projection(run)
                if name == "flagship" and args.record else None)
        mesh.collective_seconds, mesh.collective_calls = 0.0, 0
        _sync(dev)
        t0 = time.perf_counter()
        if resume:
            load_updater(path, run.updater)
            rec = runs.drive(mesh, run, steps, start=save_at)
        else:
            rec = runs.drive(mesh, run, steps, save_at=save_at, path=path)
        _sync(dev)
        wall = time.perf_counter() - t0
        # the run's own: the whole less the record's reads (runs.drive)
        rec.update(run=name, resumed=resume, steps=steps, wall_s=wall,
                   local_launches=_counts(),
                   local_collective_s=mesh.collective_seconds,
                   collective_calls=mesh.collective_calls,
                   local_run_s=wall - rec["local_record_s"],
                   run_collective_calls=(mesh.collective_calls
                                         - rec["record_collective_calls"]),
                   local_run_collective_s=(
                       mesh.collective_seconds
                       - rec["local_record_collective_s"]))
        if run.tomography is not None:
            rec["local_projections"] = run.tomography.projection_count
        if kept is not None:
            _record_flagship(mesh, run.updater.resampler, kept,
                             f"{args.record}/flagship_rank{mesh.rank}.pt")
        yield rec


def trial_digests(record):
    """A SHA-1 of each record tensor's bytes, by key."""
    return {k: hashlib.sha1(v.detach().cpu().numpy().tobytes()).hexdigest()
            for k, v in sorted(record.items())}


def task_trials(mesh, args):
    from ..distributions import UniformDistribution
    from ..ops.accelerated import AcceleratedPrecessionModel
    from ..perf_testing import perf_test_scan_batch

    trials, n, steps = args.trials
    dev = mesh.device
    tmesh = ParticleMesh.from_process_group(dev, axis_name="trials")
    _zero_counts()
    _sync(dev)
    t0 = time.perf_counter()
    runner, seeds = perf_test_scan_batch(
        AcceleratedPrecessionModel(), n, UniformDistribution([[0.0, 1.0]]),
        steps, trials, seed=args.seed, mesh=tmesh, return_runner=True,
        device=dev)
    record = runner(seeds)
    _sync(dev)
    yield {"trials": trials, "particles": n, "steps": steps,
           "wall_s": time.perf_counter() - t0,
           "digests": trial_digests(record),
           "est": record["est"][:, -1, 0].tolist(),
           "true": record["true_mps"][:, 0].tolist(),
           "resample_counts": runner.resample_counts,
           "local_launches": _counts(),
           "collective_calls": tmesh.collective_calls,
           "local_collective_s": tmesh.collective_seconds}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--init-method", required=True,
                        help="tcp://host:port or file:///path rendezvous")
    parser.add_argument("--tasks", default="jax",
                        help=f"comma-separated, from {', '.join(TASKS)}")
    parser.add_argument("--particles", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--config5", default="10000000,32,16",
                        help="N,STEPS,CANDIDATES of the config5 task")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card)")
    parser.add_argument("--backend", choices=("gloo", "nccl"),
                        default="gloo",
                        help="the process group's backend (nccl: one card "
                             "a rank)")
    parser.add_argument("--record", metavar="DIR",
                        help="where the precession and flagship runs write "
                             "each rank's kernel inputs")
    parser.add_argument("--runs", default="",
                        help="NAME:PARTICLES:STEPS[:SAVE_AT],... of the runs "
                             "task, NAME from " + ", ".join(runs.RUNS))
    parser.add_argument("--checkpoint", metavar="DIR",
                        help="where the runs task saves (and with --resume "
                             "loads) its checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="start each run with SAVE_AT from its "
                             "checkpoint")
    parser.add_argument("--trials", default="8,131072,64",
                        help="TRIALS,PARTICLES,STEPS of the trials task")
    args = parser.parse_args(argv)
    args.config5 = tuple(int(v) for v in args.config5.split(","))
    args.trials = tuple(int(v) for v in args.trials.split(","))
    tasks = [t for t in args.tasks.split(",") if t]
    unknown = set(tasks) - set(TASKS)
    if unknown:
        parser.error(f"unknown tasks {sorted(unknown)}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local_rank, local_world = host_slot(args.rank, args.world)
    if args.backend == "nccl" and (args.cpu or local_world > cards):
        raise ValueError(
            f"NCCL takes one card a rank: {local_world} ranks and "
            f"{0 if args.cpu else cards} cards"
            + (" (--cpu asks for the CPU)" if args.cpu else ""))
    device = resolve_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", card_of(local_rank, cards))
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(args.init_method, args.world, args.rank,
                         backend=args.backend)
    mesh = ParticleMesh.from_process_group(device)
    run = {"card": task_card, "jax": task_jax, "exchange": task_exchange,
           "precession": task_precession, "config5": task_config5,
           "collectives": task_collectives, "runs": task_runs,
           "trials": task_trials}
    for task in tasks:
        for result in run[task](mesh, args):
            line = {"task": task, "rank": args.rank, "world": args.world,
                    "device": str(device),
                    "collective_timer": mesh.collective_timer, **result}
            print("RESULT " + json.dumps(line), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
