"""The engine's runs that a mesh across processes is held to: each an
``SMCUpdater`` sharded over a :class:`~qinfer_tpu_torch.parallel.
ParticleMesh`, driven step by step with the same experiments and
outcomes whatever the mesh's layout, and recorded so that a run on the
ranks of a process group can be compared with the same run on a
one-process mesh of the same D.

A run is built by :func:`make_run` from its name and driven by
:func:`drive`. The runs (``RUNS``):

* the features, at a CPU size, on a fixed schedule of experiments drawn
  up front: ``time_dependent`` (a random walk of the precession
  frequency), ``keyed`` (ALE's Monte-Carlo likelihood), ``mh_fixed``,
  ``mh_adaptive`` (Metropolis moves over the full record, the scale fixed
  or adapted), ``mh_compressed`` (adaptive moves over the compressed
  record), ``waste_free`` (waste-free resample-move), all on the binomial
  coin but the first two; ``diagnostics`` (``debug_resampling`` and
  ``track_resampling_divergence``), ``est_meanfn`` and
  ``est_kl_divergence`` on precession;
* the card's legs: ``flagship`` (the resample-move recipe of two-qubit
  process tomography: 255 parameters, 64 shots, 8 adaptive sweeps, the
  ESS every 4th step, a record drawn up front), and ``drift`` (the walk
  of ``item8_bench``), ``drift_waste_free`` (its static model under
  waste-free resample-move) and ``ale`` (``item8_bench``'s ALE run), the
  last three with PGH designs as ``item8_bench`` draws them.

The record of a run (:func:`drive`) holds, for every step, the values
every rank shares (the normalization, the posterior mean, the resample
count, the design, a hash of the generator's state before the step) and,
for each shard the process holds, checksums of its weights' and
locations' bits before the step; and at the end the estimates, the
acceptances and what the run's feature reports. The record's own reads
(the estimates are collectives on the ranks) are timed and counted apart
from the run's.
"""

from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch

from .mesh import reducer_of
from .resample import DistributedLiuWestResampler

__all__ = ["RUNS", "FEATURES", "FLAGSHIP_FLAGS", "COIN", "make_run", "drive",
           "checksums", "waste_free_acceptance"]

#: the runs of the CPU tests, at a CPU size
FEATURES = ("time_dependent", "keyed", "mh_fixed", "mh_adaptive",
            "mh_compressed", "waste_free", "diagnostics", "est_meanfn",
            "est_kl_divergence")
RUNS = FEATURES + ("flagship", "drift", "drift_waste_free", "ale")
#: the resample-move recipe's ``tomography_bench`` flags (those of
#: ``chip_smoke.py``'s resample-move path)
FLAGSHIP_FLAGS = ("--process --process-qubits 2 --shots 64 --moves 8 "
                  "--adapt --target-accept 0.14 --interval 4 "
                  "--no-move-canonicalize")
#: the seed of every run's updater, and of its world (truth and outcomes)
SEED = 3
#: the walk of the drift runs: start, step sd, shots an experiment
DRIFT = (0.7, 0.005, 40)
#: the coin runs' truth and shots a step: 20 steps of 50 shots put the
#: Beta posterior's sd near 0.015, a fourteenth of the prior mean's
#: distance from the truth
COIN = (0.7, 50)
#: waste-free stages of the coin and of the static drift model
WASTE_FREE_STAGES = 8
#: the parameters whose posterior mean the record keeps each step
EST_PARAMS = 16


def checksums(mesh, tensor):
    """One int64 checksum of the raw bits of each local shard of a tensor
    sharded over ``mesh`` (its particle axis first), on the device: equal
    bits give equal sums, whatever the process."""
    bits = mesh.shard(tensor.contiguous()).reshape(mesh.local_shards, -1)
    bits = bits.view(torch.int32).to(torch.int64)
    pos = torch.arange(bits.shape[1], device=bits.device) % 1_000_003 + 1
    return (bits * pos).sum(dim=1)


def _state_hash(generator):
    return hashlib.sha1(generator.get_state().numpy().tobytes()).hexdigest()


class Run:
    """A run on a mesh: its ``updater``; ``step(k)`` committing step k and
    returning its PGH design's t, or ``None`` for a run whose experiments
    are fixed up front (which can resume at any step); ``truth()``, the
    current true parameters (or ``None``); ``report()`` of what its
    feature computes; ``fidelity()`` of a tomography run's mean, and its
    ``tomography`` model."""

    def __init__(self, updater, step, truth=None, report=None,
                 fidelity=None, tomography=None):
        self.updater = updater
        self.step = step
        self.truth = truth or (lambda: None)
        self.report = report or (lambda: {})
        self.fidelity = fidelity
        self.tomography = tomography


def _world(device, seed=SEED + 100):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _updater(mesh, model, n, prior, seed=SEED, **opts):
    """The run's updater on ``mesh``, resampling by the two-level Liu-West
    in either layout (the one algorithm a mesh across processes runs)."""
    from ..smc import SMCUpdater

    opts.setdefault("resampler", DistributedLiuWestResampler(mesh, a=0.98))
    return SMCUpdater(model, n, prior, seed=seed,
                      sharding=mesh.particle_sharding, **opts)


def _fixed_record(model, device, steps, experiment, truth, walk=False):
    """Experiments ``experiment(k)`` and outcomes at the truth (moved
    after each outcome for a walk) for ``steps`` steps, drawn up front
    from the world generator: ``[(outcome, eps)]`` and the final truth."""
    g = _world(device)
    record = []
    for k in range(steps):
        eps = experiment(k)
        record.append((model.simulate_experiment(g, truth, eps)
                       .reshape(-1)[:1], eps))
        if walk:
            truth = model.update_timestep(g, truth, eps)[:, :, 0]
    return record, truth


def _precession_times(device):
    def experiment(k):
        return {"t": torch.full((1,), (9 / 8) ** (k % 32), device=device)}
    return experiment


def _committed(u, record, check=None):
    def step(k):
        o, eps = record[k]
        u.update(o, eps, check_for_resample=True if check is None
                 else check(k))
    return step


def _coin(mesh, n, steps, **opts):
    from ..derived_models import BinomialModel
    from ..distributions import UniformDistribution
    from ..test_models import CoinModel

    dev = mesh.device
    truth, shots = COIN
    model = BinomialModel(CoinModel(), n_meas_max=shots)
    u = _updater(mesh, model, n, UniformDistribution([[0.0, 1.0]]), **opts)
    eps = {"exp_num": torch.zeros((1,), dtype=torch.int32, device=dev),
           "n_meas": torch.full((1,), shots, dtype=torch.int32, device=dev)}
    record, _ = _fixed_record(model, dev, steps, lambda k: eps,
                              torch.tensor([[truth]], device=dev))
    return Run(u, _committed(u, record), truth=lambda: [truth])


def waste_free_acceptance(u, seed=SEED + 200):
    """The mean acceptance of one more waste-free move of ``u``'s ensemble
    over its whole compressed record, as ``u`` would make it, drawn from
    a generator of its own (seeded ``seed``): the updater records no
    waste-free acceptance, and its own draws stay as they were."""
    from .. import rejuvenation as rj

    pool_eps, succ, trials = u._pool_arrays()
    _, _, acc = rj.waste_free_rejuvenate_binomial(
        u.model, u.prior, _world(u._state.weights.device, seed),
        u._state.weights, u._state.locations, succ, trials, pool_eps,
        u.waste_free_stages, proposal_scale=u._fixed_proposal_scale(),
        canonicalize=u.mcmc_canonicalize, kernel=u.waste_free_kernel,
        lw_seed_a=u.waste_free_lw_seed, beta=u.waste_free_beta,
        mesh=u._mesh)
    return float(acc)


def _precession(mesh, n, steps, **opts):
    from ..distributions import UniformDistribution
    from ..test_models import SimplePrecessionModel

    dev = mesh.device
    model = SimplePrecessionModel()
    u = _updater(mesh, model, n, UniformDistribution([[0.0, 1.0]]), **opts)
    record, _ = _fixed_record(model, dev, steps, _precession_times(dev),
                              torch.tensor([[0.7]], device=dev))
    return Run(u, _committed(u, record), truth=lambda: [0.7])


def _walk_model(shots=DRIFT[2]):
    from ..derived_models import BinomialModel, RandomWalkModel
    from ..distributions import NormalDistribution
    from ..test_models import SimplePrecessionModel

    base = BinomialModel(SimplePrecessionModel(), n_meas_max=shots)
    return RandomWalkModel(base, NormalDistribution(0.0, DRIFT[1] ** 2)), base


def _time_dependent(mesh, n, steps, **opts):
    from ..distributions import UniformDistribution

    dev = mesh.device
    model, _ = _walk_model()
    u = _updater(mesh, model, n, UniformDistribution([[0.0, 1.0]]), **opts)
    n_meas = torch.full((1,), DRIFT[2], dtype=torch.int32, device=dev)
    times = _precession_times(dev)
    record, truth = _fixed_record(
        model, dev, steps, lambda k: dict(times(k % 12), n_meas=n_meas),
        torch.tensor([[DRIFT[0]]], device=dev), walk=True)
    truth = truth.cpu().double().numpy()[0].tolist()
    return Run(u, _committed(u, record), truth=lambda: truth)


def _keyed(mesh, n, steps, error_tol=0.05, **opts):
    from ..ale import ALEApproximateModel
    from ..distributions import UniformDistribution
    from ..test_models import SimplePrecessionModel

    dev = mesh.device
    sim = SimplePrecessionModel()
    model = ALEApproximateModel(sim, error_tol=error_tol)
    u = _updater(mesh, model, n, UniformDistribution([[0.0, 1.0]]), **opts)
    record, _ = _fixed_record(sim, dev, steps, _precession_times(dev),
                              torch.tensor([[0.7]], device=dev))
    return Run(u, _committed(u, record), truth=lambda: [0.7],
               report=lambda: {"rounds": list(model.rounds)})


def _pgh_run(mesh, n, model, prior, truth, walk=False, fields=None,
             **opts):
    """An ``item8_bench`` run: PGH designs (with ``fields``), outcomes at
    the truth from the world generator, the truth moved after each
    outcome for a walk."""
    from ..heuristics import PGH

    u = _updater(mesh, model, n, prior, **opts)
    pgh = PGH(u, other_fields=fields)
    world = _world(mesh.device)
    state = {"truth": torch.tensor([truth], device=mesh.device)}

    def step(k):
        e = pgh(k)
        o = model.simulate_experiment(world, state["truth"], e)
        u.update(o.reshape(-1), e)
        if walk:
            state["truth"] = model.update_timestep(world, state["truth"],
                                                   e)[:, :, 0]
        return float(e["t"].reshape(-1)[0])

    return Run(u, step, truth=lambda: state["truth"].cpu().double()
               .numpy()[0].tolist())


def _drift(mesh, n, waste_free=False, ale=False, error_tol=0.02, **opts):
    from ..ale import ALEApproximateModel
    from ..distributions import UniformDistribution
    from ..test_models import SimplePrecessionModel

    prior = UniformDistribution([[0.0, 1.0]])
    if ale:
        model = ALEApproximateModel(SimplePrecessionModel(),
                                    error_tol=error_tol)
        run = _pgh_run(mesh, n, model, prior, [0.7], **opts)
        run.report = lambda: {"rounds": list(model.rounds)}
        return run
    walk, base = _walk_model()
    n_meas = torch.full((1,), DRIFT[2], dtype=torch.int32,
                        device=mesh.device)
    if waste_free:
        return _pgh_run(mesh, n, base, prior, [DRIFT[0]],
                        fields={"n_meas": n_meas},
                        waste_free_stages=WASTE_FREE_STAGES,
                        compress_mcmc_record=True,
                        zero_weight_policy="reset", **opts)
    return _pgh_run(mesh, n, walk, prior, [DRIFT[0]], walk=True,
                    fields={"n_meas": n_meas}, **opts)


def _flagship(mesh, n, steps, **opts):
    from .. import tomography_bench as tb
    from ..derived_models import BinomialModel

    dev = mesh.device
    flags = tb.moves_from_args(tb.parse_args(FLAGSHIP_FLAGS.split()))
    cfg = tb.make_config("process", dev, process_qubits=2)
    model = BinomialModel(cfg.model, n_meas_max=flags.shots)
    u = _updater(mesh, model, n, cfg.prior,
                 resampler=DistributedLiuWestResampler(mesh, a=0.98,
                                                       maxiter=4),
                 n_mcmc_moves=flags.moves, compress_mcmc_record=True,
                 mcmc_canonicalize=not flags.no_move_canonicalize,
                 mcmc_adapt=flags.adapt,
                 mcmc_target_accept=flags.target_accept,
                 zero_weight_policy="reset", **opts)
    g = torch.Generator(device=dev)
    g.manual_seed(2024)
    shots = torch.full((1,), flags.shots, dtype=torch.int32, device=dev)
    true = cfg.true_mps.to(dev)
    record = []
    for idx in range(steps):
        eps, _ = cfg.propose(g, idx, None, None)
        eps = dict(eps, n_meas=shots)
        record.append((model.simulate_experiment(g, true, eps)
                       .reshape(-1)[:1], eps))
    true_rho = cfg.model.modelparams_to_states(true.cpu())[0]

    def fidelity():
        est = u.est_mean().cpu().numpy()
        return float(cfg.model.fidelity_with(est[None], true_rho)[0])

    every = flags.interval
    return Run(u, _committed(u, record, lambda k: k % every == every - 1),
               fidelity=fidelity, tomography=cfg.model)


def make_run(mesh, name, n, steps, seed=SEED):
    """The run ``name`` (``RUNS``) of ``n`` particles on ``mesh``,
    ``steps`` steps deep (the fixed runs draw their record up front), its
    updater seeded ``seed``."""
    coin = {"mh_fixed": dict(n_mcmc_moves=3),
            "mh_adaptive": dict(n_mcmc_moves=3, mcmc_adapt=True),
            "mh_compressed": dict(n_mcmc_moves=3, mcmc_adapt=True,
                                  compress_mcmc_record=True,
                                  mcmc_canonicalize=False),
            "waste_free": dict(waste_free_stages=WASTE_FREE_STAGES,
                               compress_mcmc_record=True,
                               zero_weight_policy="reset")}
    if name in coin:
        run = _coin(mesh, n, steps, seed=seed, **coin[name])
        if name == "waste_free":
            run.report = lambda: {
                "waste_free_acceptance": waste_free_acceptance(run.updater)}
        return run
    if name == "time_dependent":
        return _time_dependent(mesh, n, steps, seed=seed)
    if name == "keyed":
        return _keyed(mesh, n, steps, seed=seed)
    if name == "diagnostics":
        run = _precession(mesh, n, steps, seed=seed, debug_resampling=True,
                          track_resampling_divergence=True)
        run.report = lambda: {
            "divergences": list(run.updater.resampling_divergences)}
        return run
    if name == "est_meanfn":
        run = _precession(mesh, n, steps, seed=seed)
        run.report = lambda: {"meanfn": {
            k: v.tolist() for k, v in run.updater.est_meanfn(
                lambda x: {"sq": x * x, "cos": torch.cos(x)}).items()}}
        return run
    if name == "est_kl_divergence":
        run = _precession(mesh, n, steps, seed=seed)
        prior = _precession(mesh, n, 0, seed=seed).updater

        def kl():
            u = run.updater
            return {"kl": [float(u.est_kl_divergence(prior)),
                           float(prior.est_kl_divergence(u))]}

        run.report = kl
        return run
    if name == "flagship":
        return _flagship(mesh, n, steps, seed=seed)
    if name == "drift":
        return _drift(mesh, n, seed=seed)
    if name == "drift_waste_free":
        return _drift(mesh, n, waste_free=True, seed=seed)
    if name == "ale":
        return _drift(mesh, n, ale=True, seed=seed)
    raise ValueError(f"unknown run {name!r} (one of {', '.join(RUNS)})")


def _sd(u):
    return torch.sqrt(torch.clamp_min(torch.diag(u.est_covariance_mtx()),
                                      0.0))


class _Recording:
    """The record's own work (checksums, the estimates it reads, their
    collectives), timed and counted apart from the run's: the device is
    synchronized on entering and on leaving, so the run's queued work is
    not charged to it. Adds ``local_record_s``,
    ``record_collective_calls`` and ``local_record_collective_s`` to the
    record."""

    def __init__(self, mesh, rec):
        self.mesh, self.rec = mesh, rec
        rec.update(local_record_s=0.0, record_collective_calls=0,
                   local_record_collective_s=0.0)

    def _sync(self):
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        self.calls = self.mesh.collective_calls
        self.seconds = self.mesh.collective_seconds

    def __exit__(self, *exc):
        self._sync()
        self.rec["local_record_s"] += time.perf_counter() - self.t0
        self.rec["record_collective_calls"] += (self.mesh.collective_calls
                                                - self.calls)
        self.rec["local_record_collective_s"] += (
            self.mesh.collective_seconds - self.seconds)


def drive(mesh, run, steps, start=0, save_at=None, path=None):
    """Drive ``run`` from step ``start`` to ``steps``, saving the updater
    to ``path`` after ``save_at`` steps (:func:`~qinfer_tpu_torch.
    checkpoint.save_updater`). Returns the record (see the module): lists
    a step each of ``norm``, ``est`` (of the first ``EST_PARAMS``
    parameters), ``resamples``, ``design`` (PGH runs)
    and ``generator`` (the state's hash before the step), the ``local_w``
    and ``local_x`` checksums before each step, a list a local shard
    (``local_at_save``: those at the save), the finals, and the wall and
    collectives of the record's own work (``local_record_s``,
    ``record_collective_calls``, ``local_record_collective_s``), which a
    caller timing the run takes from its own reading."""
    from ..checkpoint import save_updater

    u = run.updater
    red = reducer_of(u.sharding)
    rec = {k: [] for k in ("norm", "est", "resamples", "design",
                           "generator")}
    recording = _Recording(mesh, rec)
    sums_w, sums_x = [], []
    if run.fidelity is not None:
        with recording:
            rec["prior_fidelity"] = run.fidelity()
    for k in range(start, steps):
        with recording:
            rec["generator"].append(_state_hash(u.generator))
            sums_w.append(checksums(mesh, u.particle_weights))
            sums_x.append(checksums(mesh, u.particle_locations))
        design = run.step(k)
        with recording:
            rec["norm"].append(u.normalization_record[-1])
            rec["est"].append(u.est_mean()[:EST_PARAMS].tolist())
            rec["resamples"].append(u.resample_count)
        if design is not None:
            rec["design"].append(design)
        if save_at is not None and k + 1 == save_at:
            save_updater(path, u)
            with recording:
                rec["local_at_save"] = [
                    checksums(mesh, u.particle_weights).tolist(),
                    checksums(mesh, u.particle_locations).tolist()]
    with recording:
        rec["local_w"] = torch.stack(sums_w).T.tolist() if sums_w else []
        rec["local_x"] = torch.stack(sums_x).T.tolist() if sums_x else []
        rec["local_final"] = [checksums(mesh, u.particle_weights).tolist(),
                              checksums(mesh, u.particle_locations).tolist()]
        sd = _sd(u)
        rec.update(
            particles=u.n_particles,
            local_rows=int(u.particle_weights.shape[0]),
            final_est=u.est_mean().tolist(), final_sd=sd.tolist(),
            resample_count=u.resample_count,
            acceptance=list(u.mcmc_acceptance_record),
            log_scale=float(u._mcmc_log_scale), n_ess=u.n_ess,
            finite=red.all(torch.isfinite(u.particle_locations).all(dim=1)
                           & torch.isfinite(u.particle_weights)),
            **run.report())
        truth = run.truth()
        if truth is not None:
            rec["truth"] = truth
            rec["z"] = [abs(e - t) / max(s, 1e-12) for e, t, s in
                        zip(rec["final_est"], truth, rec["final_sd"])]
        if run.fidelity is not None:
            rec["fidelity"] = run.fidelity()
    return rec


def first_resample(rec):
    """The index of the first step that resampled (its record's inputs
    are the step's), or ``None``."""
    return next((k for k, c in enumerate(rec["resamples"])
                 if c > (rec["resamples"][k - 1] if k else 0)), None)


def alike_steps(a, b):
    """How many steps two records of one run share to the design: up to
    the first step whose PGH design differs (all of them for a fixed
    run)."""
    da, db = a["design"], b["design"]
    return next((k for k, (x, y) in enumerate(zip(da, db)) if x != y),
                len(a["norm"]))


def rel_diff(a, b):
    """The largest relative difference of two records of a step value
    (a float or a vector a step): max over steps of max |a − b| / max
    |b| (a vector's scale, so that its entries near 0 do not blow it
    up)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return float(np.max(np.max(np.abs(a - b), axis=1)
                        / np.maximum(np.max(np.abs(b), axis=1), 1e-30)))


def combined_sd(a, b):
    """The combined posterior sd of two runs' final estimates, a parameter
    each."""
    return [math.hypot(x, y) for x, y in zip(a["final_sd"], b["final_sd"])]
