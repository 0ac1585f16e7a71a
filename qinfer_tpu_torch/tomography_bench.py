"""Tomography benchmark of the port: particle-updates/s and the recovered
fidelity of adaptive tomography on one CUDA device (counterpart of
``benchmarks/tomography_bench.py``).

* ``--process [--process-qubits 1|2]``: process tomography of a
  depolarizing-0.25 channel, BCSZ prior over Choi states, random
  (prep, meas) pairs from the 4^nq tetrahedral product fiducials. At two
  qubits: 255 parameters, embedded 32×32 Choi states, so every resample's
  strict PSD projection runs kernel K5.
* ``--diffusive``: two-qubit state tomography of a diffusing state (a
  0.8-Bell mixture), Ginibre prior, random product-Pauli effects; every
  step diffuses all particles and projects the ones that left the cone
  (kernel K4 at embedded d = 8).
* plain state tomography ``--qubits N``: a GHZ-leaning mixed state (a
  fixed qubit state at N = 1), Ginibre prior, random Pauli projectors.

Each step: proposal → outcome simulated at the true parameters → (the
diffusive truth moves) → SMC update with an ESS check (threshold 0.5,
every ``--interval``-th step) and ``LiuWestResampler(a=0.98, maxiter=4)``,
K3 filling the ancestors. With ``--shots S`` the model is
``BinomialModel(model, n_meas_max=S)`` and each experiment gives a count
of S shots. With ``--moves K`` every resample is followed by K Metropolis
sweeps over the record (``--adapt``, ``--mcmc-method`` and
``--target-accept`` choose the kernel); ``--waste-free P`` replaces the
resample and the moves by waste-free resample-move. For the process and
state modes the record is the sufficient statistics of the fixed
candidate pool (every (prep, meas) pair, or every projector), kept on the
device; ``--record full`` keeps every outcome and experiment instead.
With ``--eig`` the process and state modes choose each experiment from
the candidate pool by the two-outcome expected information gain of the
underlying model (``--eig-policy``: greedy, egreedy with
``--eig-epsilon``, softmax or auto), scored on the device and picked
there; ``--eig-interval K > 1`` rescores only every K-th step and right
after a step that resampled.
The resampler skips its own strict projection when the moves re-project
(``--moves`` without ``--no-move-canonicalize``) or ``--project-every``
projects periodically: at least one strict projection per resample-move
event. One warm-up run of at most 200 steps, then ``--repeats`` (3)
timed runs, each from a fresh prior ensemble (drawn before the clock
starts); the rate is over the best wall. The fidelity of the posterior
mean to the truth is computed on the host, as is the prior mean's, which
the posterior must beat.

Run with ``python -m qinfer_tpu_torch.tomography_bench [mode] [options]``.
It refuses to run without a CUDA device unless ``--cpu`` asks for the CPU
(the result then names the CPU as its device). Prints ONE JSON line; with
moves its ``mean_move_acceptance`` and ``final_log_scale``, and with
``--eig`` its ``n_rescores``, hold one value per timed run.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
import time
from functools import reduce

import numpy as np
import torch

from .bench import card_label, parse_refusing, profile_device_time
from .derived_models import BinomialModel
from .expdesign import select_candidate
from .resamplers import LiuWestResampler
from .smc import (SMCState, _expected_information_gain, _update_step,
                  resample_interval_gate)
from . import rejuvenation as rj
from . import tomography as tomo

N_REPEATS = 3
#: steps of the warm-up run (it builds the kernels and the libraries'
#: handles; its result is not kept)
WARMUP_STEPS = 200
#: flags of the JAX benchmark whose modules the port does not have yet
NOT_PORTED = ()


@dataclasses.dataclass
class Design:
    """The experiment design of a run (``--eig``, ``--eig-policy``,
    ``--eig-epsilon`` and ``--eig-interval``)."""

    policy: str = "greedy"
    epsilon: float = 0.25
    interval: int = 1

    def rescore(self, idx, just_resampled):
        """Whether step ``idx`` scores the pool afresh: every step at
        interval 1, else every ``interval``-th step and the step after a
        resample (``just_resampled`` of the state this step starts
        from)."""
        return (self.interval <= 1 or idx % self.interval == 0
                or just_resampled)


@dataclasses.dataclass
class Config:
    """One benchmark configuration: the tomography model, its prior, the
    truth (a (1, d) CPU tensor), a proposal ``propose(generator, idx,
    weights, locations, scores=None) -> (expparams, pool index)`` on the
    device, the candidate pool (``pool_eps``, None for the diffusive mode,
    whose effects carry a time) and the metric's name. With a ``design``
    the proposal picks from the pool by ``pool_scores(weights,
    locations)``, the pool's expected information gains (scored anew when
    ``scores`` is None)."""

    metric: str
    model: object
    prior: object
    true_mps: torch.Tensor
    propose: object
    pool_eps: dict = None
    design: Design = None
    pool_scores: object = None


@dataclasses.dataclass
class Moves:
    """The resample-move options of a run (the bench flags of the same
    names); the defaults are a run without moves."""

    shots: int = 0
    moves: int = 0
    proposal_scale: float = None
    mcmc_method: str = "rwm"
    target_accept: float = None
    adapt: bool = False
    interval: int = 0
    waste_free: int = 0
    waste_free_kernel: str = "rwm"
    waste_free_lw_seed: float = None
    waste_free_beta: float = 0.3
    strict_resample_canonicalize: bool = False
    project_every: int = 0
    no_move_canonicalize: bool = False
    record: str = "auto"

    @property
    def adaptive(self):
        return self.moves > 0 and (self.adapt or self.mcmc_method != "rwm")

    def sufficient(self, cfg):
        """Whether the moves target the pool's sufficient statistics."""
        return (self.moves > 0 and self.record != "full"
                and cfg.pool_eps is not None)

    def check(self, cfg):
        """The JAX benchmark's refusals, as ``SystemExit``."""
        if self.shots > 0 and cfg.pool_eps is None:
            raise SystemExit("--shots requires a time-independent "
                             "two-outcome config (--process or plain "
                             "state tomography)")
        if self.moves > 0 and bool(cfg.model.is_time_dependent):
            raise SystemExit("--moves requires a time-independent config "
                             "(rejuvenation targets a fixed record "
                             "posterior)")
        if self.project_every > 0 and (self.moves == 0
                                       or self.waste_free > 0):
            raise SystemExit("--project-every requires the sufficient-"
                             "record move path (--moves > 0, no "
                             "--waste-free)")
        if self.adaptive and not self.sufficient(cfg):
            raise SystemExit("--adapt / --mcmc-method mala require the "
                             "sufficient-statistic record path")
        if self.adaptive and self.waste_free > 0:
            raise SystemExit("--adapt / --mcmc-method mala apply to the "
                             "post-resample move kernel, not --waste-free")

    def resampler(self):
        """Liu-West with its own strict projection unless the moves
        re-project or ``--project-every`` projects: at least one strict
        projection per resample-move event (without one, the JAX
        package's 255-parameter flagship fell from fidelity 0.98 to
        0.48-0.65)."""
        return LiuWestResampler(
            a=0.98, maxiter=4,
            canonicalize=(self.moves == 0
                          or (self.no_move_canonicalize
                              and self.project_every == 0)
                          or self.strict_resample_canonicalize))


def _uniform_index(n, generator, device):
    """A uniform index in [0, n) drawn on the device: (1,)."""
    return torch.randint(0, n, (1,), generator=generator, device=device)


def _designed(cfg, design):
    """``cfg`` with ``design``: the proposal picks from the pool by the
    expected information gain of the two-outcome model (the binomial
    count's gain over an (S + 1)-outcome grid would cost S/2 times as
    much, and the single-shot gain stands in for it at a fixed S)."""
    if design is None:
        return cfg
    if cfg.pool_eps is None:
        raise SystemExit("--eig requires a candidate pool (--process or "
                         "plain state tomography): the diffusive effects "
                         "carry a time")
    model, pool = cfg.model, cfg.pool_eps
    first = next(iter(pool.values()))
    outcomes = torch.arange(2, dtype=torch.int32, device=first.device)
    mask = torch.ones((2, first.shape[0]), device=first.device)

    def pool_scores(weights, locations):
        return _expected_information_gain(model, weights, locations,
                                          outcomes, mask, pool)

    def propose(generator, idx, weights, locations, scores=None):
        if scores is None:
            scores = pool_scores(weights, locations)
        pick = select_candidate(generator, scores, policy=design.policy,
                                epsilon=design.epsilon).reshape(1)
        return {k: v[pick] for k, v in pool.items()}, pick

    return dataclasses.replace(cfg, propose=propose, design=design,
                               pool_scores=pool_scores)


def process_config(nq, device):
    """Process tomography of the depolarizing-0.25 channel on ``nq``
    qubits, with random pairs of tetrahedral product fiducials."""
    if nq not in (1, 2):
        raise SystemExit("--process-qubits must be 1 or 2")
    dd = 2 ** nq
    b1 = tomo.pauli_basis(nq)
    b2 = tomo.pauli_basis(2 * nq)
    model = tomo.ProcessTomographyModel(b2, b1)
    prior = tomo.BCSZChoiDistribution(b2)
    J_id = np.zeros((dd * dd, dd * dd), dtype=np.complex64)
    for mm in range(dd):
        for nn in range(dd):
            E = np.zeros((dd, dd), dtype=np.complex64)
            E[mm, nn] = 1
            J_id += np.kron(E, E)
    p_dep = 0.25
    true_rho = ((1 - p_dep) * J_id
                + p_dep * np.kron(np.eye(dd), np.eye(dd) / dd)) / dd
    true_mps = model.states_to_modelparams(true_rho[None])
    kets1 = np.asarray(
        [[1, 0], [0, 1],
         [1 / np.sqrt(2), 1 / np.sqrt(2)],
         [1 / np.sqrt(2), 1j / np.sqrt(2)]], dtype=np.complex64)
    kets = [reduce(np.kron, combo)
            for combo in itertools.product(kets1, repeat=nq)]
    fid = torch.stack([b1.state_to_modelparams(np.outer(k, k.conj()))
                       for k in kets]).to(device)  # (4^nq, dd²)
    n_fid = fid.shape[0]
    # the candidate pool: every (prep, meas) pair, row i·n_fid + j
    pool_eps = {"prep": fid.repeat_interleave(n_fid, dim=0),
                "meas": fid.repeat(n_fid, 1)}

    def propose(generator, idx, weights, locations, scores=None):
        i = _uniform_index(n_fid, generator, device)
        j = _uniform_index(n_fid, generator, device)
        return {"prep": fid[i], "meas": fid[j]}, i * n_fid + j

    return Config("process_tomography_particle_updates_per_s", model, prior,
                  true_mps, propose, pool_eps)


def diffusive_config(rate, device):
    """Two-qubit diffusive state tomography with product-Pauli effects."""
    b2 = tomo.pauli_basis(2)
    model = tomo.DiffusiveTomographyModel(b2, diffusion_rate=rate)
    prior = tomo.GinibreDistribution(b2)
    psi = np.array([1, 0, 0, 1], dtype=np.complex64) / np.sqrt(2)
    true_rho = (0.8 * np.outer(psi, psi.conj())
                + 0.2 * np.eye(4, dtype=np.complex64) / 4)
    true_mps = model.states_to_modelparams(true_rho[None])
    P1 = [np.eye(2, dtype=np.complex64),
          np.array([[0, 1], [1, 0]], np.complex64),
          np.array([[0, -1j], [1j, 0]], np.complex64),
          np.array([[1, 0], [0, -1]], np.complex64)]
    effs = [b2.state_to_modelparams(
                (np.eye(4, dtype=np.complex64) + np.kron(P1[a], P1[b])) / 2)
            for a in range(4) for b in range(4) if a or b]
    eff = torch.stack(effs).to(device)  # (15, 16)
    t_one = torch.ones((1,), device=device)

    def propose(generator, idx, weights, locations, scores=None):
        return {"meas": eff[_uniform_index(eff.shape[0], generator,
                                           device)], "t": t_one}, None

    return Config("diffusive_tomography_particle_updates_per_s", model,
                  prior, true_mps, propose)


def state_config(qubits, device):
    """Plain state tomography on ``qubits`` qubits with random Pauli
    projectors."""
    basis = tomo.pauli_basis(qubits)
    model = tomo.TomographyModel(basis)
    prior = tomo.GinibreDistribution(basis)
    if qubits == 1:
        true_rho = np.array([[0.85, 0.3], [0.3, 0.15]], dtype=np.complex64)
    else:
        dd = 2 ** qubits
        psi = np.zeros(dd, dtype=np.complex64)
        psi[0] = psi[-1] = 1 / np.sqrt(2)
        true_rho = (0.75 * np.outer(psi, psi.conj())
                    + 0.25 * np.eye(dd, dtype=np.complex64) / dd)
    true_mps = model.states_to_modelparams(true_rho[None])
    d = basis.dim
    eye_coords = np.zeros(basis.n_ops)
    eye_coords[0] = np.sqrt(d)
    proj = torch.tensor(
        0.5 * (eye_coords[None, :] + np.sqrt(d) * np.eye(basis.n_ops))[1:],
        dtype=torch.float32, device=device)

    def propose(generator, idx, weights, locations, scores=None):
        pick = _uniform_index(proj.shape[0], generator, device)
        return {"meas": proj[pick]}, pick

    # the projectors double as the sufficient-statistic candidate pool
    return Config("tomography_particle_updates_per_s", model, prior,
                  true_mps, propose, {"meas": proj})


def make_config(mode, device, process_qubits=2, qubits=1,
                diffusion_rate=0.003, design=None):
    """``mode`` is ``"process"``, ``"diffusive"`` or ``"state"``;
    ``design`` a :class:`Design` for ``--eig`` (the process and state
    modes only)."""
    if mode == "process":
        cfg = process_config(process_qubits, device)
    elif mode == "diffusive":
        cfg = diffusive_config(diffusion_rate, device)
    else:
        cfg = state_config(qubits, device)
    return _designed(cfg, design)


def fidelity(model, locations, weights, true_mps):
    """Host fidelity of the weighted mean state to the true state."""
    est = (weights @ locations).detach().cpu().numpy()
    true_rho = model.modelparams_to_states(true_mps.cpu())[0]
    return float(model.fidelity_with(est[None], true_rho)[0])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_loop(cfg, state, n_steps, generator, opts=None):
    """Drive ``n_steps`` adaptive steps from ``state`` with the
    resample-move options ``opts`` (a :class:`Moves`; none by default).
    The record's totals grow on the device (``index_add_``), the moves run
    only on steps that resampled, and the acceptances and the adapted
    scale stay on the device until the end. With a design the pool's
    scores are carried between rescores (:meth:`Design.rescore`) and stay
    on the device, as does the pick. Returns the final state, the
    (possibly diffused) truth and the run's tally: ``move_calls``,
    ``mean_move_acceptance``, ``final_log_scale``, ``n_rescores`` (None
    without a design) and ``resample_steps`` (the steps that
    resampled)."""
    opts = opts if opts is not None else Moves()
    opts.check(cfg)
    dev = state.locations.device
    model = cfg.model
    if opts.shots > 0:
        model = BinomialModel(model, n_meas_max=opts.shots)
        shots = torch.full((1,), opts.shots, dtype=torch.int32, device=dev)
    resampler = opts.resampler()
    true = cfg.true_mps.to(dev)
    time_dependent = bool(model.is_time_dependent)
    sufficient = opts.sufficient(cfg)
    waste_free = sufficient and opts.waste_free > 0
    move_canon = (not opts.no_move_canonicalize) and opts.project_every == 0
    scale = 2.38 if opts.proposal_scale is None else opts.proposal_scale
    if sufficient:
        n_pool = next(iter(cfg.pool_eps.values())).shape[0]
        succ = torch.zeros((n_pool,), dtype=torch.int32, device=dev)
        trials = torch.zeros((n_pool,), dtype=torch.int32, device=dev)
    record_outcomes, record_eps = [], []
    log_scale = adapt_t = None
    if opts.adaptive:
        log_scale = rj.initial_log_scale(int(model.n_modelparams),
                                         opts.mcmc_method,
                                         opts.proposal_scale)
        adapt_t = 0
    acc_sum = torch.zeros((), device=dev)
    move_calls = 0
    design = cfg.design
    scores, n_rescores, resample_steps = None, 0, []
    n = state.weights.shape[0]
    for idx in range(n_steps):
        if design is not None and design.rescore(idx, state.just_resampled):
            scores = cfg.pool_scores(state.weights, state.locations)
            n_rescores += 1
        eps, pool_idx = cfg.propose(generator, idx, state.weights,
                                    state.locations, scores)
        if opts.shots > 0:
            eps = dict(eps, n_meas=shots)
        outcome = model.simulate_experiment(generator, true, eps).reshape(-1)
        if time_dependent:
            true = model.update_timestep(generator, true, eps)[:, :, 0]
        gate = resample_interval_gate(idx, opts.interval)
        state, _, _ = _update_step(
            model, resampler, state, outcome[:1], eps, 0.5, 1e-10, generator,
            check_resample=not waste_free, resample_gate=gate)
        if state.just_resampled:
            resample_steps.append(idx)
        if sufficient:
            # success := underlying outcome 0 (a count with shots)
            if opts.shots > 0:
                succ.index_add_(0, pool_idx, outcome[:1].to(torch.int32))
                trials.index_add_(0, pool_idx, shots)
            else:
                succ.index_add_(0, pool_idx,
                                (outcome[:1] == 0).to(torch.int32))
                trials.index_add_(0, pool_idx, torch.ones_like(succ[:1]))
        elif opts.moves > 0:
            record_outcomes.append(outcome[:1])
            record_eps.append(eps)
        if waste_free:
            ess = float(1.0 / torch.sum(state.weights * state.weights))
            if (gate is None or gate) and ess <= 0.5 * n:
                w, x, acc = rj.waste_free_rejuvenate_binomial(
                    model, cfg.prior, generator, state.weights,
                    state.locations, succ, trials, cfg.pool_eps,
                    opts.waste_free, scale,
                    canonicalize=not opts.no_move_canonicalize,
                    kernel=opts.waste_free_kernel,
                    lw_seed_a=opts.waste_free_lw_seed,
                    beta=opts.waste_free_beta)
                state = dataclasses.replace(
                    state, weights=w, locations=x, just_resampled=True,
                    resample_count=state.resample_count + 1)
                resample_steps.append(idx)
                acc_sum, move_calls = acc_sum + acc, move_calls + 1
            continue
        if opts.moves == 0 or not state.just_resampled:
            continue
        if opts.adaptive:
            x, acc, log_scale, adapt_t = (
                rj.mcmc_rejuvenate_binomial_adaptive(
                    model, cfg.prior, generator, state.locations, succ,
                    trials, cfg.pool_eps, opts.moves, log_scale, adapt_t,
                    method=opts.mcmc_method,
                    target_accept=opts.target_accept,
                    canonicalize=move_canon, adapt=opts.adapt))
        elif sufficient:
            x, acc = rj.mcmc_rejuvenate_binomial(
                model, cfg.prior, generator, state.locations, succ, trials,
                cfg.pool_eps, opts.moves, scale, canonicalize=move_canon)
        else:
            rec_eps = {k: torch.cat([e[k] for e in record_eps])
                       for k in record_eps[0]}
            rec_out = torch.cat(record_outcomes)
            x, acc = rj.mcmc_rejuvenate(
                model, cfg.prior, generator, state.locations, rec_out,
                rec_eps, torch.ones_like(rec_out, dtype=torch.bool),
                opts.moves, scale, canonicalize=move_canon)
        if (opts.project_every > 0
                and state.resample_count % opts.project_every == 0):
            x = model.canonicalize(x)
        state = dataclasses.replace(state, locations=x)
        acc_sum, move_calls = acc_sum + acc, move_calls + 1
    moves = {"move_calls": move_calls,
             "mean_move_acceptance": (float(acc_sum) / max(move_calls, 1)
                                      if opts.moves > 0 else None),
             "final_log_scale": (float(log_scale) if opts.adaptive
                                 else None),
             "n_rescores": n_rescores if design is not None else None,
             "resample_steps": resample_steps}
    return state, true, moves


def timed_run(cfg, n_particles, n_steps, seed, device, opts=None):
    """One run: draw the prior ensemble (not timed), then time the loop
    between two device synchronizations. Resets the model's projection
    count first. Returns a dict with ``wall_s``, the final ``state`` and
    ``true``, the ``fidelity``, the ``prior_fidelity`` (the initial
    ensemble's mean against the final truth), ``projections`` and the
    run's tally (:func:`run_loop`)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = SMCState.initial(cfg.prior.sample(generator, n_particles))
    prior_mean = (state.weights, state.locations)
    cfg.model.projection_count = 0
    _sync(device)
    t0 = time.perf_counter()
    state, true, moves = run_loop(cfg, state, n_steps, generator, opts)
    _sync(device)
    wall = time.perf_counter() - t0
    return {
        "wall_s": wall,
        "state": state,
        "true": true,
        "fidelity": fidelity(cfg.model, state.locations, state.weights,
                             true),
        "prior_fidelity": fidelity(cfg.model, prior_mean[1], prior_mean[0],
                                   true),
        "projections": cfg.model.projection_count,
        **moves,
    }


def profiled_run(cfg, n_particles, n_steps, seed, device, path, opts=None):
    """One more run under :mod:`torch.profiler` (see
    :func:`qinfer_tpu_torch.bench.profile_device_time`)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = SMCState.initial(cfg.prior.sample(generator, n_particles))
    return profile_device_time(
        lambda: run_loop(cfg, state, n_steps, generator, opts), device, path)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--particles", type=int, default=500_000)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--process", action="store_true")
    parser.add_argument("--process-qubits", type=int, default=1)
    parser.add_argument("--diffusive", action="store_true")
    parser.add_argument("--diffusion-rate", type=float, default=0.003)
    parser.add_argument("--qubits", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--shots", type=int, default=0,
                        help="shots per experiment: the model becomes "
                        "BinomialModel(model, n_meas_max=shots)")
    parser.add_argument("--moves", type=int, default=0,
                        help="Metropolis sweeps after every resample")
    parser.add_argument("--proposal-scale", type=float, default=None,
                        help="random-walk scale over sqrt(d) (default: "
                        "the method's constant, 2.38 rwm / 1.65 mala); "
                        "with --adapt it seeds the initial scale")
    parser.add_argument("--mcmc-method", default="rwm",
                        choices=["rwm", "mala"])
    parser.add_argument("--target-accept", type=float, default=None,
                        help="Robbins-Monro target for --adapt (default "
                        "0.234 rwm / 0.574 mala)")
    parser.add_argument("--adapt", action="store_true",
                        help="Robbins-Monro adaptation of the step size")
    parser.add_argument("--interval", type=int, default=0,
                        help="check the ESS only every K-th step (0: "
                        "every step)")
    parser.add_argument("--waste-free", type=int, default=0,
                        help="P > 0: waste-free resample-move with P "
                        "stages in place of the resample and the moves "
                        "(needs --moves > 0 to enable the record)")
    parser.add_argument("--waste-free-kernel", default="rwm",
                        choices=["rwm", "pcn"])
    parser.add_argument("--waste-free-lw-seed", type=float, default=None)
    parser.add_argument("--waste-free-beta", type=float, default=0.3)
    parser.add_argument("--strict-resample-canonicalize",
                        action="store_true",
                        help="keep the resampler's strict projection "
                        "even when the moves re-project")
    parser.add_argument("--project-every", type=int, default=0,
                        help="strict-project the ensemble on every K-th "
                        "resample-move event instead of after each move "
                        "call")
    parser.add_argument("--no-move-canonicalize", action="store_true",
                        help="skip the strict projection at the end of "
                        "each move call")
    parser.add_argument("--record", default="auto",
                        choices=["auto", "full"],
                        help="'full' keeps every outcome and experiment "
                        "instead of the pool's sufficient statistics")
    parser.add_argument("--eig", action="store_true",
                        help="choose each experiment from the candidate "
                        "pool by expected information gain (process and "
                        "state modes)")
    parser.add_argument("--eig-policy", default="greedy",
                        choices=["greedy", "egreedy", "softmax", "auto"],
                        help="candidate-selection policy for --eig")
    parser.add_argument("--eig-epsilon", type=float, default=0.25,
                        help="exploration rate of --eig-policy egreedy "
                        "(and auto)")
    parser.add_argument("--eig-interval", type=int, default=1,
                        help="rescore the pool every K-th step and after "
                        "a step that resampled (1: every step)")
    parser.add_argument("--repeats", type=int, default=N_REPEATS,
                        help="timed runs after the warm-up")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions of the "
                        "kernels); the result names the CPU")
    parser.add_argument("--profile", metavar="PATH",
                        help="after the timed runs, profile one more run "
                        "and write its device time by kernel to PATH")
    return parse_refusing(parser, argv, NOT_PORTED)


def moves_from_args(args):
    """The :class:`Moves` of the parsed flags."""
    return Moves(**{f.name: getattr(args, f.name)
                    for f in dataclasses.fields(Moves)})


def design_from_args(args):
    """The :class:`Design` of the parsed flags, None without ``--eig``."""
    if not args.eig:
        return None
    return Design(policy=args.eig_policy, epsilon=args.eig_epsilon,
                  interval=args.eig_interval)


def main(argv=None):
    args = parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
        device_name, card = "cpu", None
    else:
        if not torch.cuda.is_available():
            print("no CUDA device: pass --cpu to run on the CPU",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        device_name, card = torch.cuda.get_device_name(device), card_label()
    mode = ("process" if args.process else
            "diffusive" if args.diffusive else "state")
    design = design_from_args(args)
    cfg = make_config(mode, device, args.process_qubits, args.qubits,
                      args.diffusion_rate, design)
    opts = moves_from_args(args)
    n, steps = args.particles, args.steps

    timed_run(cfg, n, min(steps, WARMUP_STEPS), 1000 * args.seed, device,
              opts)
    runs = [timed_run(cfg, n, steps, 1000 * args.seed + rep + 1, device,
                      opts)
            for rep in range(args.repeats)]
    walls = [r["wall_s"] for r in runs]
    best = min(walls)
    fids = [r["fidelity"] for r in runs]
    ok = all(f > r["prior_fidelity"] for f, r in zip(fids, runs))
    result = {
        "metric": cfg.metric,
        "impl": "torch",
        "device": device_name,
        "card": card,
        "n_particles": n,
        "n_steps": steps,
        "n_qubits": None if mode != "state" else args.qubits,
        "process_qubits": args.process_qubits if mode == "process" else None,
        "shots": opts.shots,
        "mcmc_moves": opts.moves,
        "mcmc_method": opts.mcmc_method if opts.moves > 0 else None,
        "mcmc_adapt": opts.adapt,
        "value": n * steps / best,
        "fidelity": min(fids),
        "fidelities": fids,
        "prior_fidelities": [r["prior_fidelity"] for r in runs],
        "resamples": [r["state"].resample_count for r in runs],
        "projections": [r["projections"] for r in runs],
        "move_calls": [r["move_calls"] for r in runs],
        "mean_move_acceptance": [r["mean_move_acceptance"] for r in runs],
        "final_log_scale": [r["final_log_scale"] for r in runs],
        "eig_design": design is not None,
        "eig_policy": design.policy if design else None,
        "eig_interval": design.interval if design else None,
        "n_rescores": [r["n_rescores"] for r in runs],
        "wall_s": best,
        "repeat_walls_s": walls,
        "ok": ok,
    }
    if args.profile:
        wall, device_s = profiled_run(cfg, n, steps,
                                      1000 * args.seed + args.repeats + 1,
                                      device, args.profile, opts)
        result.update(profiled_wall_s=wall, profiled_device_s=device_s,
                      device_idle_share=1.0 - device_s / best)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
