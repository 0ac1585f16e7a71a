"""The paths of the remaining models, distributions and heuristics on one
device: five runs that users of QInfer's model zoo make, each an
``SMCUpdater`` driven through its public entry points.

a. Drift tracking (QInfer's time-dependent-models guide): a qubit
   frequency that walks, ``RandomWalkModel(BinomialModel(
   SimplePrecessionModel()), NormalDistribution(0, 0.005²))`` over a
   uniform prior on [0, 1], 40 shots an experiment at PGH times, 1000
   ``update`` steps; the truth starts at ω = 0.7 and walks with the same
   step law. Then the same with ``GaussianRandomWalkModel(...,
   scale=0.005, model_mu_sigma=True)``, which learns log σ under a
   uniform prior on [log 1e-3, log 5e-2].
b. The multinomial die, a k-outcome calibration record:
   ``MultinomialModel(NDieModel(6), n_meas_max=100)`` over
   ``MVUniformDistribution(6)``, one ``batch_update`` over 200
   experiments of 100 rolls from a fixed p, the ESS checked every step.
   Then the same with the ESS checked every 5th step, for context: the
   500 rolls before its first check leave ~3 effective particles of
   50 000, and the posterior that grows from them sits 5-7 sd from the
   truth.
c. Approximate likelihood estimation for a simulator without a
   likelihood: ``ALEApproximateModel(SimplePrecessionModel(),
   error_tol=0.02)`` (adaptive), single shots at PGH times, 200 steps;
   then two identical steps, whose normalizations must differ.
d. Referenced-Poisson readout (NV-centre photon counting):
   ``ReferencedPoissonModel(SimplePrecessionModel(), max_count=512)``,
   truth (ω, α, β) = (0.7, 40, 2), a uniform prior on [0, 1] × [20, 60] ×
   [0, 5], 300 steps: every third a SIGNAL count at t from
   ``ExpSparseHeuristic(scale=1, base=1.02)``, the others BRIGHT and DARK
   in turn. Then one step each of ``MLEModel(power=2)`` and
   ``PoisonedModel(tol=0.02)`` over the same model.
e. Two-qubit state tomography under the GADFLI prior:
   ``TomographyModel(pauli_basis(2))`` with ``GADFLIDistribution(basis,
   |00⟩⟨00|, alpha=1, beta=9)``, the truth |00⟩ depolarized by 0.1,
   single shots of ``RandomPauliHeuristic`` projectors, 200 steps. Then
   the same under the Ginibre prior at the same seed, for context.

The context runs hold nothing (their ``bars`` are empty).

Every run uses 50 000 particles but (e), at 100 000. After a short
warm-up (every run at 1 % of its steps), each prints one JSON line: the
wall of the loop between two device synchronizations, the particle
updates a second, the resamples, and the run's checks (``bars``: each
held value beside its bar); the exit code is 1 if a check failed.

Run with ``python -m qinfer_tpu_torch.item8_bench [--particles N]
[--tomo-particles N] [--steps-scale F] [--device cpu]``; the card by
default, where it refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from .ale import ALEApproximateModel
from .bench import card_label
from .config import DEFAULT_DEVICE, resolve_device
from .derived_models import (BinomialModel, GaussianRandomWalkModel,
                             MLEModel, MultinomialModel, PoisonedModel,
                             RandomWalkModel, ReferencedPoissonModel)
from .distributions import (MVUniformDistribution, NormalDistribution,
                            ProductDistribution, UniformDistribution)
from .heuristics import PGH, ExpSparseHeuristic
from .smc import SMCUpdater
from .test_models import NDieModel, SimplePrecessionModel
from . import tomography as tomo

N_PARTICLES = 50_000
N_TOMO = 100_000
SEED = 3
#: drift tracking: the truth's start, the walk's step sd, shots, steps
DRIFT = (0.7, 0.005, 40, 1000)
#: the die: true face probabilities, rolls an experiment, experiments
DIE = ((0.10, 0.15, 0.20, 0.25, 0.05, 0.25), 100, 200)
ALE_STEPS = 200
#: referenced Poisson: the truth (ω, α, β) and the steps
POISSON = ((0.7, 40.0, 2.0), 300)
TOMO_STEPS = 200


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _moments(updater):
    """Posterior mean and sd (host float64)."""
    est = updater.est_mean().cpu().numpy().astype(np.float64)
    sd = np.sqrt(np.diag(updater.est_covariance_mtx().cpu().numpy())
                 .astype(np.float64))
    return est, sd


def _z(updater, truth):
    """|mean − truth| / sd of each parameter."""
    est, sd = _moments(updater)
    return np.abs(est - np.asarray(truth, np.float64)) / np.maximum(sd,
                                                                    1e-12)


class _Runner:
    """The five runs on one device with the caller's hooks:
    ``make_resampler()`` gives each updater's resampler (Liu-West a = 0.98
    by default), ``before_run()`` runs just before and ``after_run(rec)``
    just after each timed loop."""

    def __init__(self, device, make_resampler=None, before_run=None,
                 after_run=None):
        self.device = device
        self.make_resampler = make_resampler
        self.before_run = before_run
        self.after_run = after_run
        self.world = torch.Generator(device=device)
        self.world.manual_seed(SEED + 100)

    def updater(self, model, n, prior):
        return SMCUpdater(model, n, prior, seed=SEED, device=self.device,
                          resampler=(self.make_resampler()
                                     if self.make_resampler else None))

    def timed(self, name, updater, steps, loop):
        """Time ``loop()`` between two synchronizations and return the
        run's record."""
        if self.before_run is not None:
            self.before_run()
        _sync(self.device)
        t0 = time.perf_counter()
        loop()
        _sync(self.device)
        wall = time.perf_counter() - t0
        n = updater.n_particles
        rec = {"run": name, "n_particles": n, "steps": steps,
               "wall_s": wall, "particle_updates_per_s": n * steps / wall,
               "resamples": updater.resample_count, "updater": updater}
        if self.after_run is not None:
            self.after_run(rec)
        return rec

    # -- a. drift tracking --------------------------------------------------

    def drift(self, n, steps, learned=False):
        start, step_sd, shots, _ = DRIFT
        base = BinomialModel(SimplePrecessionModel(), n_meas_max=shots)
        if learned:
            model = GaussianRandomWalkModel(base, scale=step_sd,
                                            model_mu_sigma=True)
            prior = ProductDistribution(
                UniformDistribution([[0.0, 1.0]]),
                UniformDistribution([[math.log(1e-3), math.log(5e-2)]]))
            truth = [[start, math.log(step_sd)]]
        else:
            model = RandomWalkModel(base,
                                    NormalDistribution(0.0, step_sd ** 2))
            prior = UniformDistribution([[0.0, 1.0]])
            truth = [[start]]
        u = self.updater(model, n, prior)
        n_meas = torch.full((1,), shots, dtype=torch.int32,
                            device=self.device)
        pgh = PGH(u, other_fields={"n_meas": n_meas})
        state = {"truth": torch.tensor(truth, device=self.device)}

        def loop():
            for k in range(steps):
                e = pgh(k)
                o = model.simulate_experiment(self.world, state["truth"], e)
                u.update(o.reshape(-1), e)
                state["truth"] = model.update_timestep(
                    self.world, state["truth"], e)[:, :, 0]

        rec = self.timed("drift_learned" if learned else "drift", u, steps,
                         loop)
        truth = state["truth"].cpu().numpy().astype(np.float64)[0]
        est, sd = _moments(u)
        z = float(abs(est[0] - truth[0]) / max(sd[0], 1e-12))
        rec.update(truth=truth.tolist(), est=est.tolist(), sd=sd.tolist(),
                   bars=[("omega |mean - truth| / sd", z, 4.0, z <= 4.0)])
        if learned:
            w = u.particle_weights
            rec["learned_sigma"] = {
                "exp_mean_log_sigma": float(math.exp(est[1])),
                "mean_sigma": float(w @ torch.exp(u.particle_locations[:, 1])),
                "true_sigma": step_sd}
        return rec

    # -- b. the multinomial die ---------------------------------------------

    def die(self, n, n_exp, interval=1):
        p_true, rolls, _ = DIE
        model = MultinomialModel(NDieModel(len(p_true)), n_meas_max=rolls)
        u = self.updater(model, n, MVUniformDistribution(len(p_true)))
        eps = {"exp_num": torch.arange(n_exp, dtype=torch.int32,
                                       device=self.device),
               "n_meas": torch.full((n_exp,), rolls, dtype=torch.int32,
                                    device=self.device)}
        truth = torch.tensor([p_true], device=self.device)
        outs = model.simulate_experiment(self.world, truth, eps)[0]
        rec = self.timed("die" if interval == 1 else f"die_interval{interval}",
                         u, n_exp,
                         lambda: u.batch_update(outs, eps,
                                                resample_interval=interval))
        z = float(_z(u, p_true).max())
        rec.update(est=_moments(u)[0].tolist(), max_z_vs_true=z,
                   min_n_ess=u.min_n_ess, resample_interval=interval,
                   redraw_rounds=list(getattr(u.resampler, "redraw_rounds",
                                              [])),
                   bars=([("max_z_vs_true", z, 4.0, z <= 4.0)]
                         if interval == 1 else []))
        return rec

    # -- c. ALE -------------------------------------------------------------

    def ale(self, n, steps):
        sim = SimplePrecessionModel()
        model = ALEApproximateModel(sim, error_tol=0.02)
        u = self.updater(model, n, UniformDistribution([[0.0, 1.0]]))
        pgh = PGH(u)
        truth = torch.tensor([[0.7]], device=self.device)

        def loop():
            for k in range(steps):
                e = pgh(k)
                u.update(sim.simulate_experiment(self.world, truth, e)
                         .reshape(-1), e)

        rec = self.timed("ale", u, steps, loop)
        rounds = list(model.rounds)
        est, sd = _moments(u)
        z = float(abs(est[0] - 0.7) / max(sd[0], 1e-12))
        # two identical steps: equal normalizations would mean the noise
        # was not drawn afresh
        same = {"t": torch.ones((1,), device=self.device)}
        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        for _ in range(2):
            u.update(zero, same, check_for_resample=False)
        n1, n2 = u.normalization_record[-2:]
        rec.update(est=est.tolist(), sd=sd.tolist(), n_samples=model.n_samples,
                   rounds_per_step=rounds,
                   twin_normalizations=[n1, n2],
                   bars=[("omega |mean - 0.7| / sd", z, 4.0, z <= 4.0),
                         ("twin steps' normalizations differ", n1 != n2,
                          True, n1 != n2)])
        return rec

    # -- d. referenced Poisson ----------------------------------------------

    def poisson(self, n, steps):
        truth_v, _ = POISSON
        model = ReferencedPoissonModel(SimplePrecessionModel(),
                                       max_count=512)
        prior = ProductDistribution(UniformDistribution([[0.0, 1.0]]),
                                    UniformDistribution([[20.0, 60.0]]),
                                    UniformDistribution([[0.0, 5.0]]))
        u = self.updater(model, n, prior)
        sparse = ExpSparseHeuristic(u, scale=1.0, base=1.02)
        truth = torch.tensor([truth_v], device=self.device)
        modes = [torch.full((1,), m, dtype=torch.int32, device=self.device)
                 for m in (model.SIGNAL, model.BRIGHT, model.DARK)]
        t_one = torch.ones((1,), device=self.device)

        def experiment(k):
            if k % 3 == 0:
                return dict(sparse(k // 3), mode=modes[0])
            return {"t": t_one, "mode": modes[k % 3]}

        def loop():
            for k in range(steps):
                e = experiment(k)
                u.update(model.simulate_experiment(self.world, truth, e)
                         .reshape(-1), e)

        rec = self.timed("poisson", u, steps, loop)
        z = _z(u, truth_v)
        rec.update(est=_moments(u)[0].tolist(), max_z_vs_true=float(z.max()),
                   last_signal_t=float(sparse.time((steps - 1) // 3)),
                   bars=[("max_z_vs_true", float(z.max()), 4.0,
                          float(z.max()) <= 4.0)])
        return rec, model, prior, experiment

    def one_step(self, name, model, n, prior, e):
        """One update of a fresh updater over ``model``, its state held
        finite."""
        u = self.updater(model, n, prior)
        truth = torch.tensor([POISSON[0]], device=self.device)
        o = model.simulate_experiment(self.world, truth, e).reshape(-1)
        rec = self.timed(name, u, 1, lambda: u.update(o, e))
        finite = bool(torch.isfinite(u.particle_weights).all()
                      and torch.isfinite(u.particle_locations).all())
        rec["bars"] = [("finite state", finite, True, finite)]
        return rec

    # -- e. GADFLI-prior state tomography -----------------------------------

    def tomography(self, n, steps, prior_name="gadfli"):
        basis = tomo.pauli_basis(2)
        model = tomo.TomographyModel(basis)
        fiducial = np.zeros((4, 4), dtype=np.complex64)
        fiducial[0, 0] = 1.0
        if prior_name == "gadfli":
            prior = tomo.GADFLIDistribution(basis, fiducial, alpha=1.0,
                                            beta=9.0)
        else:
            prior = tomo.GinibreDistribution(basis)
        true_rho = 0.9 * fiducial + 0.1 * np.eye(4, dtype=np.complex64) / 4
        true_mps = model.states_to_modelparams(true_rho[None]).to(
            self.device)
        u = self.updater(model, n, prior)
        prior_w, prior_x = u.particle_weights, u.particle_locations
        model.projection_count = 0
        heuristic = tomo.RandomPauliHeuristic(u)

        def loop():
            for k in range(steps):
                e = heuristic(k)
                u.update(model.simulate_experiment(self.world, true_mps, e)
                         .reshape(-1), e)

        rec = self.timed(f"tomography_{prior_name}", u, steps, loop)
        fid = _fidelity(model, u.particle_weights, u.particle_locations,
                        true_rho)
        prior_fid = _fidelity(model, prior_w, prior_x, true_rho)
        rec.update(fidelity=fid, prior_fidelity=prior_fid,
                   projections=model.projection_count,
                   bars=([("fidelity above the prior mean's", fid,
                           prior_fid, fid > prior_fid)]
                         if prior_name == "gadfli" else []))
        return rec


def _fidelity(model, weights, locations, true_rho):
    est = (weights @ locations).detach().cpu().numpy()
    return float(model.fidelity_with(est[None], true_rho)[0])


def run_all(n_particles=N_PARTICLES, n_tomo=N_TOMO, device=DEFAULT_DEVICE,
            steps_scale=1.0, **hooks):
    """The five runs (module docstring) in order, ``hooks`` as
    :class:`_Runner` takes them; ``steps_scale`` scales every run's steps
    (1 for the full runs). Returns the records."""
    device = resolve_device(device)
    r = _Runner(device, **hooks)

    def steps(k):
        return max(3, int(round(k * steps_scale)))

    out = [r.drift(n_particles, steps(DRIFT[3])),
           r.drift(n_particles, steps(DRIFT[3]), learned=True),
           r.die(n_particles, steps(DIE[2])),
           r.die(n_particles, steps(DIE[2]), interval=5),
           r.ale(n_particles, steps(ALE_STEPS))]
    rec, model, prior, experiment = r.poisson(n_particles,
                                              steps(POISSON[1]))
    out += [rec,
            r.one_step("poisson_mle_step", MLEModel(model, 2.0),
                       n_particles, prior, experiment(0)),
            r.one_step("poisson_poisoned_step", PoisonedModel(model,
                                                              tol=0.02),
                       n_particles, prior, experiment(0)),
            r.tomography(n_tomo, steps(TOMO_STEPS)),
            r.tomography(n_tomo, steps(TOMO_STEPS), prior_name="ginibre")]
    return out


def printable(rec):
    """A record without its updater, for ``json.dumps``."""
    return {k: v for k, v in rec.items() if k != "updater"}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--particles", type=int, default=N_PARTICLES)
    parser.add_argument("--tomo-particles", type=int, default=N_TOMO)
    parser.add_argument("--steps-scale", type=float, default=1.0,
                        help="scale every run's steps (a CPU rehearsal)")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="where to run (default: the card)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        name, card = torch.cuda.get_device_name(device), card_label()
    else:
        name, card = str(device), None
    # a short warm-up builds the kernels and the libraries' handles
    run_all(args.particles, args.tomo_particles, device, 0.01)
    ok = True
    for rec in run_all(args.particles, args.tomo_particles, device,
                       args.steps_scale):
        ok = ok and all(b[3] for b in rec["bars"])
        print(json.dumps({"impl": "torch", "device": name, "card": card,
                          **printable(rec)}, default=str), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
