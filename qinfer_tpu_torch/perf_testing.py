"""Performance-testing harness (counterpart of
:mod:`qinfer_tpu.perf_testing`).

* :func:`perf_test`: one full adaptive inference run, heuristic →
  simulate → update, as a host loop through :meth:`SMCUpdater.update`,
  recording loss, timing and resampling per step; and
  :func:`perf_test_multiple`, independent trials of it.
* :func:`perf_test_scan`: the same run as one loop over the engine's
  update step (``smc._update_step``) whose per-step record stays on the
  device until the end.
* :func:`perf_test_scan_batch`: many independent trials, the port's
  replacement of the reference package's ipyparallel fan-out. Without a
  mesh the trials run batched on one device (a leading trial axis on
  every engine tensor: one proposal call, one likelihood call, one ESS
  gate and, where trials resample, one batched Liu-West resample with one
  K3 launch a step); with a mesh (a ``'trials'`` ``ParticleMesh`` or a
  list of devices) each device runs its block of trials one after
  another, each with its own branching.

Trial t of :func:`perf_test_scan_batch` is seeded ``trial_seeds[t]``, one
32-bit word of ``numpy.random.SeedSequence([seed, t])``. Its generator
draws its prior ensemble, then its true parameters; in the sequential mode
it then drives the whole run. In the batched mode the draws made for all
trials at once (proposals, outcomes, resamples) come from one batch
generator seeded by ``SeedSequence(trial_seeds)``. So a trial's prior and
truth are the same in both modes, and ``runner(trial_seeds)`` replays a
run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import rejuvenation as rj
from .abstract_model import atleast_2d
from .config import DEFAULT_DEVICE, EPS, resolve_device
from .heuristics import PGH
from .parallel.mesh import LOCAL, ParticleMesh, placement
from .resamplers import LiuWestResampler
from .smc import (SMCState, SMCUpdater, _reweight_batch, _simulate_batch,
                  _trial, _update_step, resample_interval_gate)

__all__ = ["perf_test", "perf_test_multiple", "perf_test_scan",
           "perf_test_scan_batch", "TrialRunner", "PERF_DTYPE"]

#: Per-step record dtype (the reference's structured array fields).
PERF_DTYPE = [
    ("elapsed_time", np.float64),
    ("loss", np.float64),
    ("resample_count", np.int64),
    ("outcome", np.float64),
]


def perf_test(model, n_particles, prior, n_exp, heuristic_class=PGH,
              true_model=None, true_prior=None, true_mps=None,
              extra_updater_args=None, seed=0, device=DEFAULT_DEVICE):
    """Run one full adaptive inference experiment and record per-step
    performance.

    Same protocol as the reference: draw the true parameters from
    ``true_prior`` (default: the inference prior) unless ``true_mps`` is
    given, then loop ``heuristic → true_model.simulate_experiment →
    (a time-dependent true model's update_timestep) → updater.update``,
    recording the Q-weighted quadratic loss of the posterior mean against
    the current true parameters, the wall time of the step and the
    resample count.

    ``device`` is the card by default; without a CUDA device, pass
    ``device="cpu"``: the default raises there.

    :return: ``(performance, extra)``: a structured array of length
        ``n_exp`` with fields ``PERF_DTYPE``, and a dict with the
        ``updater``, ``true_mps`` and the per-step estimates ``est``.
    """
    true_model = true_model if true_model is not None else model
    true_prior = true_prior if true_prior is not None else prior
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    if true_mps is None:
        true_mps = true_prior.sample(generator, 1)
    true_mps = atleast_2d(torch.as_tensor(true_mps, dtype=torch.float32,
                                          device=device))

    updater = SMCUpdater(model, n_particles, prior, seed=seed + 1,
                         device=device, **(extra_updater_args or {}))
    heuristic = heuristic_class(updater)

    performance = np.zeros((n_exp,), dtype=PERF_DTYPE)
    ests = np.zeros((n_exp, model.n_modelparams))
    Q = model.Q.numpy()
    time_dependent = bool(true_model.is_time_dependent)

    for idx in range(n_exp):
        t0 = time.perf_counter()
        eps = heuristic(idx)
        outcome = true_model.simulate_experiment(generator, true_mps, eps)
        if time_dependent:
            true_mps = true_model.update_timestep(
                generator, true_mps, eps)[:, :, 0]
        updater.update(outcome, eps)
        est = updater.est_mean().cpu().numpy()
        delta = est - true_mps[0].cpu().numpy()
        performance[idx]["elapsed_time"] = time.perf_counter() - t0
        performance[idx]["loss"] = float(np.sum(Q * delta * delta))
        performance[idx]["resample_count"] = updater.resample_count
        performance[idx]["outcome"] = float(outcome.reshape(-1)[0])
        ests[idx] = est

    extra = {
        "updater": updater,
        "true_mps": true_mps.cpu().numpy(),
        "est": ests,
    }
    return performance, extra


def perf_test_multiple(n_trials, model, n_particles, prior, n_exp,
                       heuristic_class=PGH, true_model=None, true_prior=None,
                       apply=None, progressbar=None, seed=0,
                       device=DEFAULT_DEVICE, **kwargs):
    """:func:`perf_test` over ``n_trials`` independent trials, trial ``i``
    seeded ``seed + 1000·i``. ``apply(fn, i)`` runs one trial (serially by
    default): an executor may return a handle with ``get()``.
    ``progressbar`` is a factory of an object with optional ``start(max=)``,
    ``update(i)`` and ``finished()``. The card by default, as
    :func:`perf_test`: without a CUDA device, pass ``device="cpu"``.

    :return: structured array ``(n_trials, n_exp)`` of ``PERF_DTYPE``.
    """
    device = resolve_device(device)
    results = np.zeros((n_trials, n_exp), dtype=PERF_DTYPE)
    prog = progressbar() if progressbar is not None else None
    if prog is not None and hasattr(prog, "start"):
        prog.start(max=n_trials)

    def one_trial(i):
        perf, _ = perf_test(
            model, n_particles, prior, n_exp, heuristic_class,
            true_model=true_model, true_prior=true_prior,
            seed=seed + 1000 * i, device=device, **kwargs)
        return perf

    for i in range(n_trials):
        if apply is not None:
            r = apply(one_trial, i)
            results[i] = r.get() if hasattr(r, "get") else r
        else:
            results[i] = one_trial(i)
        if prog is not None and hasattr(prog, "update"):
            prog.update(i + 1)
    if prog is not None and hasattr(prog, "finished"):
        prog.finished()
    return results


def perf_test_scan(model, n_particles, prior, n_exp, heuristic_factory=None,
                   true_mps=None, resample_thresh=0.5, resampler=None,
                   seed=0, sharding=None, zero_weight_policy="reset",
                   device=None):
    """One adaptive inference run as one loop over the engine's update step
    (``smc._update_step``, so one device→host copy a step, the ESS gate's),
    with the per-step record kept on the device until the end.

    The protocol of the JAX package's ``perf_test_scan``: a generator
    seeded ``seed`` draws the true parameters from the prior (unless
    ``true_mps`` is given), then each step's proposal and outcome; the
    updater (seeded ``seed + 1``) draws its ensemble and its resamples.
    A time-dependent model moves the true parameters after each outcome
    (``update_timestep``). The card by default: without a CUDA device,
    pass ``device="cpu"``. With a particle ``sharding``
    (``ParticleMesh.particle_sharding``) the updater's ensemble is sharded
    over the mesh, on its device (see :class:`SMCUpdater`). On a mesh
    across processes every rank runs this function with the same
    arguments; the record (estimates, losses, ESS, evidence) and the
    resample count are the same on every rank, the final state the rank's
    block.

    :param heuristic_factory: ``f(updater) -> Heuristic`` (PGH by default).
    :return: ``(updater, record)``: the updater with the final state
        committed, and per-step tensors ``loss`` (n_exp,), ``ess``
        (n_exp,), ``norm`` (n_exp,), ``est`` (n_exp, d) and the final
        ``true_mps`` (1, d).
    """
    device = placement(device, sharding)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if true_mps is None:
        true_mps = prior.sample(generator, 1)
    true = atleast_2d(torch.as_tensor(true_mps, dtype=torch.float32,
                                      device=device))
    updater = SMCUpdater(model, n_particles, prior, seed=seed + 1,
                         resample_thresh=resample_thresh,
                         resampler=resampler,
                         zero_weight_policy=zero_weight_policy,
                         sharding=sharding, device=device)
    heuristic = (heuristic_factory(updater) if heuristic_factory is not None
                 else PGH(updater))
    st, true, record, log_norms = _scan_steps(
        model, heuristic, updater.resampler, updater.state, true, n_exp,
        generator, updater.generator, updater.resample_thresh,
        updater.zero_weight_thresh, on_zero=updater._handle_zero_weight,
        reducer=updater._reducer, mesh=updater._mesh)
    updater.state = st
    # the step's log-normalization came to the host with its ESS gate
    record["norm"] = torch.exp(torch.tensor(log_norms, dtype=torch.float32,
                                            device=device))
    record["true_mps"] = true
    return updater, record


def _scan_steps(model, heuristic, resampler, st, true, n_exp, g_run,
                g_update, resample_thresh, zero_weight_thresh,
                resample_interval=0, on_zero=None, after_update=None,
                reducer=LOCAL, mesh=None):
    """The one-ensemble loop of :func:`perf_test_scan` and of a mesh trial:
    each step a proposal and an outcome at the truth drawn from ``g_run``
    (the truth then moved, for a time-dependent model), the engine's
    update step drawing from ``g_update`` with the ESS checked where
    ``resample_interval`` allows, ``on_zero()`` when the weights were
    annihilated, ``after_update(state, outcome, eps, idx) -> state``, and
    the step's loss, ESS and estimate kept on the device, each summed over
    the whole ensemble by ``reducer`` (see ``smc._update_step``). Returns
    ``(state, truth, {loss, ess, est}, the steps' log-normalizations)``."""
    Q = model.Q.to(st.weights.device)
    time_dependent = bool(model.is_time_dependent)
    losses, esses, ests, log_norms = [], [], [], []
    for idx in range(n_exp):
        eps = heuristic.propose(g_run, st.weights, st.locations, idx)
        outcome = model.simulate_experiment(g_run, true, eps).reshape(-1)[:1]
        if time_dependent:
            true = model.update_timestep(g_run, true, eps)[:, :, 0]
        st, log_norm, was_zero = _update_step(
            model, resampler, st, outcome, eps, resample_thresh,
            zero_weight_thresh, g_update, check_resample=True,
            resample_gate=resample_interval_gate(idx, resample_interval),
            reducer=reducer, mesh=mesh)
        if was_zero and on_zero is not None:
            on_zero()
        if after_update is not None:
            st = after_update(st, outcome, eps, idx)
        # the estimate and Σw² in one reduction
        sums = reducer.sum(torch.cat([st.weights @ st.locations, torch.sum(
            st.weights * st.weights)[None]]))
        est = sums[:-1]
        delta = est - true[0]
        losses.append(torch.sum(Q * delta * delta))
        esses.append(1.0 / sums[-1])
        ests.append(est)
        log_norms.append(log_norm)
    record = {"loss": torch.stack(losses), "ess": torch.stack(esses),
              "est": torch.stack(ests)}
    return st, true, record, log_norms


@dataclasses.dataclass
class _Trials:
    """What every trial of :func:`perf_test_scan_batch` shares."""

    model: object
    prior: object
    n_particles: int
    n_exp: int
    resampler: object
    resample_thresh: float
    zero_weight_thresh: float
    heuristic: object
    n_mcmc_moves: int
    mcmc_proposal_scale: float
    resample_interval: int

    def setup(self, seed, device):
        """Trial set-up from its seed: ``(generator, prior ensemble (n, d)
        canonicalized, true parameters (1, d))``."""
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        locations = self.model.canonicalize(
            self.prior.sample(g, self.n_particles))
        true = atleast_2d(self.prior.sample(g, 1)).to(torch.float32)
        return g, locations, true

    def moved(self, generator, locations, out_buf, eps_buf, idx):
        """Metropolis moves of one trial that resampled at step ``idx``,
        over its own record up to and including that step."""
        mask = torch.arange(self.n_exp, device=locations.device) <= idx
        x, _ = rj.mcmc_rejuvenate(
            self.model, self.prior, generator, locations, out_buf, eps_buf,
            mask, self.n_mcmc_moves, self.mcmc_proposal_scale)
        return x


def _record_buffers(n_exp, outcome, eps):
    """Zeroed per-trial record buffers shaped after one step's outcome
    (...,) and experiment fields (..., 1, ...): ``(outcomes (..., n_exp),
    {field: (..., n_exp, ...)})``."""
    lead = outcome.shape
    out_buf = torch.zeros(lead + (n_exp,), dtype=outcome.dtype,
                          device=outcome.device)
    eps_buf = {k: torch.zeros(lead + (n_exp,) + tuple(v.shape[len(lead) + 1:]),
                              dtype=v.dtype, device=v.device)
               for k, v in eps.items()}
    return out_buf, eps_buf


def _sequential_trial(trials, seed, device):
    """One trial with real branching (the mesh mode): the engine's update
    step on one ensemble, every draw from the trial's generator. Returns
    ``(record, resample count)``."""
    tr = trials
    g, locations, true = tr.setup(seed, device)
    bufs = []

    def moves(st, outcome, eps, idx):
        # the trial's record, then its moves after a resample
        if not bufs:
            bufs.extend(_record_buffers(tr.n_exp, outcome[0], eps))
        out_buf, eps_buf = bufs
        out_buf[idx] = outcome[0]
        for k, v in eps.items():
            eps_buf[k][idx] = v[0]
        if not st.just_resampled:
            return st
        return dataclasses.replace(st, locations=tr.moved(
            g, st.locations, out_buf, eps_buf, idx))

    st, true, record, _ = _scan_steps(
        tr.model, tr.heuristic, tr.resampler, SMCState.initial(locations),
        true, tr.n_exp, g, g, tr.resample_thresh, tr.zero_weight_thresh,
        tr.resample_interval,
        after_update=moves if tr.n_mcmc_moves > 0 else None)
    record.update(true_mps=true[0], final_weights=st.weights,
                  final_locations=st.locations)
    return record, st.resample_count


def _run_sequential(trials, trial_seeds, mesh):
    """The mesh mode: equal blocks of trials in device order, each block's
    trials one after another on its device; the records stacked on the
    mesh's first device."""
    block = len(trial_seeds) // len(mesh)
    records, counts = [], []
    for b, device in enumerate(mesh):
        for seed in trial_seeds[b * block:(b + 1) * block]:
            rec, count = _sequential_trial(trials, seed, device)
            records.append(rec)
            counts.append(count)
    out = {k: torch.stack([r[k].to(mesh[0]) for r in records])
           for k in records[0]}
    return out, counts


def _run_across_processes(trials, trial_seeds, mesh):
    """The trial mesh across processes: rank r runs block r of the trials
    (the mesh mode's blocks, in rank order) by :func:`_run_sequential` on
    its device, then the ranks' records are gathered, so every rank
    returns every trial's record, stacked in trial order."""
    block = len(trial_seeds) // mesh.n_devices
    out, counts = _run_sequential(
        trials, trial_seeds[mesh.rank * block:(mesh.rank + 1) * block],
        [mesh.device])
    out = {k: mesh.unshard(mesh.all_gather(v[None])) for k, v in out.items()}
    counts = mesh.unshard(mesh.all_gather(torch.tensor(
        counts, dtype=torch.int64, device=mesh.device)[None]))
    return out, counts.tolist()


def _run_batched(trials, trial_seeds, device):
    """The batched mode: every engine tensor carries a leading trial axis.

    Each step: one batched proposal (``heuristic.propose_batch``), one
    batched outcome simulation and reweight (``smc._simulate_batch``,
    ``smc._reweight_batch``: ``torch.func.vmap`` over the trials, or one
    call a trial for models that reach a hand kernel or draw Monte-Carlo
    noise), and on steps the interval gate allows, ONE device→host copy:
    the trials whose ESS fell to the threshold. Only those resample,
    together (:meth:`LiuWestResampler.call_batch_with_diagnostics`, one K3
    launch), and with moves each of them then runs its Metropolis sweeps
    over its own record. Returns ``(record, resample counts)``."""
    tr = trials
    model = tr.model
    if not hasattr(tr.resampler, "call_batch_with_diagnostics"):
        raise TypeError("the batched trial engine needs a resampler with "
                        "call_batch_with_diagnostics (LiuWestResampler)")
    locs, trues = [], []
    for seed in trial_seeds:
        _, x0, t0 = tr.setup(seed, device)
        locs.append(x0)
        trues.append(t0)
    x = torch.stack(locs)  # (T, n, d)
    true = torch.stack(trues)  # (T, 1, d)
    T, n, _ = x.shape
    w = torch.full((T, n), 1.0 / n, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [int(s) for s in trial_seeds]).generate_state(1)[0]))
    Q = model.Q.to(device)
    time_dependent = bool(model.is_time_dependent)
    counts = torch.zeros((T,), dtype=torch.int64, device=device)
    bufs = None
    losses, esses, ests = [], [], []
    for idx in range(tr.n_exp):
        eps = tr.heuristic.propose_batch(g, w, x, idx)  # (T, 1, ...)
        outcome = _simulate_batch(model, g, true, eps)  # (T,)
        if time_dependent:
            true = torch.stack([model.update_timestep(
                g, true[t], _trial(eps, t))[:, :, 0] for t in range(T)])
        hyp, norm = _reweight_batch(model, w, x, outcome, eps, g)
        was_zero = norm <= tr.zero_weight_thresh
        w = torch.where(was_zero[:, None], 1.0 / n,
                        hyp / torch.clamp_min(norm, EPS)[:, None])
        if time_dependent:
            x = torch.stack([model.update_timestep(
                g, x[t], _trial(eps, t))[:, :, 0] for t in range(T)])
        if tr.n_mcmc_moves > 0:
            if bufs is None:
                bufs = _record_buffers(tr.n_exp, outcome, eps)
            out_buf, eps_buf = bufs
            out_buf[:, idx] = outcome
            for k, v in eps.items():
                eps_buf[k][:, idx] = v[:, 0]
        gate = resample_interval_gate(idx, tr.resample_interval)
        if gate is None or gate:
            ess = 1.0 / torch.sum(w * w, dim=1)
            # the step's one device→host copy
            rows = torch.nonzero(ess <= tr.resample_thresh * n).flatten()
            if rows.numel():
                w_r, x_r, _ = tr.resampler.call_batch_with_diagnostics(
                    model, g, w[rows], x[rows])
                if tr.n_mcmc_moves > 0:
                    x_r = torch.stack([tr.moved(
                        g, x_r[i], out_buf[t], _trial(eps_buf, t), idx)
                        for i, t in enumerate(rows.tolist())])
                w = w.index_copy(0, rows, w_r)
                x = x.index_copy(0, rows, x_r)
                counts[rows] += 1
        est = torch.bmm(w[:, None, :], x)[:, 0, :]
        delta = est - true[:, 0, :]
        losses.append(torch.sum(Q * delta * delta, dim=1))
        esses.append(1.0 / torch.sum(w * w, dim=1))
        ests.append(est)
    record = {
        "loss": torch.stack(losses, dim=1),
        "ess": torch.stack(esses, dim=1),
        "est": torch.stack(ests, dim=1),
        "true_mps": true[:, 0, :],
        "final_weights": w,
        "final_locations": x,
    }
    return record, counts.tolist()


class TrialRunner:
    """The run of :func:`perf_test_scan_batch` as a callable:
    ``runner(trial_seeds)`` runs the trials and returns the stacked
    record, so a benchmark can time warm calls. After each call
    ``resample_counts`` lists each trial's resamples."""

    def __init__(self, run):
        self._run = run
        self.resample_counts = None

    def __call__(self, trial_seeds):
        record, self.resample_counts = self._run(list(trial_seeds))
        return record


def perf_test_scan_batch(model, n_particles, prior, n_exp, n_trials,
                         resample_thresh=0.5, resampler=None, seed=0,
                         mesh=None, axis_name="trials",
                         zero_weight_thresh=1e-10,
                         heuristic_factory=None, n_mcmc_moves=0,
                         mcmc_proposal_scale=2.38, resample_interval=0,
                         return_runner=False, device=DEFAULT_DEVICE):
    """``n_trials`` independent adaptive inference runs (the JAX package's
    ``perf_test_scan_batch``): each trial draws its prior ensemble and its
    true parameters from the prior, then runs ``n_exp`` steps of proposal
    (PGH unless ``heuristic_factory(stub)`` gives another heuristic; the
    stub carries only ``model``), outcome at its truth (moved by
    ``update_timestep`` for a time-dependent model) and update with the
    ESS checked on the steps ``resample_interval`` allows (every step
    for 0; every K-th for K), with ``zero_weight_thresh`` resetting
    annihilated weights to uniform.

    Two modes:

    * ``mesh=None``: the trials run batched on ``device`` (the card by
      default; without a CUDA device pass ``device="cpu"``). Only the
      trials whose ESS fell resample, together, with one K3 launch a step
      (see :func:`_run_batched`). Models whose likelihood reaches a hand
      kernel through ``fused_reweight`` (``AcceleratedPrecessionModel``:
      one K1 launch a trial) or draws Monte-Carlo noise take one call a
      trial; every other model one ``torch.func.vmap`` call for all.
    * ``mesh`` a :class:`~qinfer_tpu_torch.parallel.ParticleMesh` with
      axis ``axis_name`` (``ParticleMesh(devices, axis_name="trials")``;
      its devices may differ or repeat), or a list of devices: equal
      blocks of trials in device order, each trial run alone with real
      branching; ``n_trials`` must divide by the mesh's size. On a mesh
      across processes (``ParticleMesh(axis_name="trials")`` after
      ``initialize_multihost``) rank r runs block r, seeded as in one
      process, and every rank returns all the trials' records, gathered:
      the one-process mesh's result to the bit (the JAX package's
      ``shard_map`` over a trial mesh).

    :param n_mcmc_moves: > 0 runs that many random-walk Metropolis sweeps
        (scale ``mcmc_proposal_scale``) after each resample of a trial,
        over the trial's own record (static models only).
    :param return_runner: return ``(runner, trial_seeds)`` instead of the
        record; ``runner(trial_seeds)`` (a :class:`TrialRunner`) runs it.
    :return: the stacked records ``loss`` (T, n_exp), ``ess`` (T, n_exp),
        ``est`` (T, n_exp, d), ``true_mps`` (T, d), ``final_weights``
        (T, n) and ``final_locations`` (T, n, d).
    """
    if n_mcmc_moves > 0 and bool(model.is_time_dependent):
        raise ValueError("n_mcmc_moves > 0 is incompatible with "
                         "time-dependent models (see SMCUpdater)")

    class _Stub:
        pass

    stub = _Stub()
    stub.model = model
    trials = _Trials(
        model=model, prior=prior, n_particles=int(n_particles),
        n_exp=int(n_exp),
        resampler=resampler if resampler is not None else LiuWestResampler(),
        resample_thresh=float(resample_thresh),
        zero_weight_thresh=float(zero_weight_thresh),
        heuristic=(heuristic_factory(stub) if heuristic_factory is not None
                   else PGH(stub)),
        n_mcmc_moves=int(n_mcmc_moves),
        mcmc_proposal_scale=float(mcmc_proposal_scale),
        resample_interval=int(resample_interval))
    trial_seeds = [int(np.random.SeedSequence([int(seed), t])
                       .generate_state(1)[0]) for t in range(n_trials)]
    if mesh is None:
        device = resolve_device(device)
        runner = TrialRunner(lambda seeds: _run_batched(trials, seeds,
                                                        device))
    else:
        if isinstance(mesh, ParticleMesh):
            if mesh.axis_name != axis_name:
                raise ValueError(f"the mesh has axis {mesh.axis_name!r}, "
                                 f"not {axis_name!r}")
            size, devices = mesh.n_devices, mesh.devices
        else:
            size, devices = len(mesh), mesh
        if not size or n_trials % size:
            raise ValueError(
                f"mesh size {size} must divide n_trials={n_trials} "
                "(equal trial blocks per device)")
        if isinstance(mesh, ParticleMesh) and mesh.spans_processes:
            runner = TrialRunner(lambda seeds: _run_across_processes(
                trials, seeds, mesh))
        else:
            devices = [resolve_device(dv) for dv in devices]
            runner = TrialRunner(lambda seeds: _run_sequential(
                trials, seeds, devices))
    if return_runner:
        return runner, trial_seeds
    return runner(trial_seeds)
