"""Tomography benchmark of the port: particle-updates/s and the recovered
fidelity of adaptive tomography on one CUDA device (counterpart of
``benchmarks/tomography_bench.py``'s three base modes).

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
diffusive truth moves) → SMC update with an ESS check (threshold 0.5) and
``LiuWestResampler(a=0.98, maxiter=4, canonicalize=True)``, K3 filling the
ancestors. One warm-up run, then three timed repeats, each from a fresh
prior ensemble (drawn before the clock starts); the rate is over the best
wall. The fidelity of the posterior mean to the truth is computed on the
host, as is the prior mean's, which the posterior must beat.

Run with ``python -m qinfer_tpu_torch.tomography_bench [mode] [options]``.
It refuses to run without a CUDA device unless ``--cpu`` asks for the CPU
(the result then names the CPU as its device). Prints ONE JSON line.
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

from .bench import card_label, profile_device_time
from .resamplers import LiuWestResampler
from .smc import SMCState, _update_step
from . import tomography as tomo

N_REPEATS = 3
#: flags of the JAX benchmark whose modules the port does not have yet
NOT_PORTED = ("eig", "moves", "shots", "waste_free", "adapt",
              "project_every")


@dataclasses.dataclass
class Config:
    """One benchmark configuration: the model, its prior, the truth (a
    (1, d) CPU tensor), a proposal ``propose(generator, idx) -> expparams``
    on the device, and the metric's name."""

    metric: str
    model: object
    prior: object
    true_mps: torch.Tensor
    propose: object


def _uniform_pick(table, generator):
    """Row of ``table`` at a uniform index drawn on the device: (1, k)."""
    i = torch.randint(0, table.shape[0], (1,), generator=generator,
                      device=table.device)
    return table[i]


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

    def propose(generator, idx):
        return {"prep": _uniform_pick(fid, generator),
                "meas": _uniform_pick(fid, generator)}

    return Config("process_tomography_particle_updates_per_s", model, prior,
                  true_mps, propose)


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

    def propose(generator, idx):
        return {"meas": _uniform_pick(eff, generator), "t": t_one}

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

    def propose(generator, idx):
        return {"meas": _uniform_pick(proj, generator)}

    return Config("tomography_particle_updates_per_s", model, prior,
                  true_mps, propose)


def make_config(mode, device, process_qubits=2, qubits=1,
                diffusion_rate=0.003):
    """``mode`` is ``"process"``, ``"diffusive"`` or ``"state"``."""
    if mode == "process":
        return process_config(process_qubits, device)
    if mode == "diffusive":
        return diffusive_config(diffusion_rate, device)
    return state_config(qubits, device)


def make_resampler():
    return LiuWestResampler(a=0.98, maxiter=4, canonicalize=True)


def fidelity(model, locations, weights, true_mps):
    """Host fidelity of the weighted mean state to the true state."""
    est = (weights @ locations).detach().cpu().numpy()
    true_rho = model.modelparams_to_states(true_mps.cpu())[0]
    return float(model.fidelity_with(est[None], true_rho)[0])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_loop(cfg, state, n_steps, generator):
    """Drive ``n_steps`` adaptive steps from ``state``; returns the final
    state and the (possibly diffused) truth."""
    model = cfg.model
    resampler = make_resampler()
    true = cfg.true_mps.to(state.locations.device)
    time_dependent = bool(model.is_time_dependent)
    for idx in range(n_steps):
        eps = cfg.propose(generator, idx)
        outcome = model.simulate_experiment(generator, true, eps).reshape(-1)
        if time_dependent:
            true = model.update_timestep(generator, true, eps)[:, :, 0]
        state, _, _ = _update_step(
            model, resampler, state, outcome[:1], eps, 0.5, 1e-10, generator)
    return state, true


def timed_run(cfg, n_particles, n_steps, seed, device):
    """One run: draw the prior ensemble (not timed), then time the loop
    between two device synchronizations. Resets the model's projection
    count first. Returns a dict with ``wall_s``, the final ``state`` and
    ``true``, the ``fidelity``, the ``prior_fidelity`` (the initial
    ensemble's mean against the final truth) and ``projections``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = SMCState.initial(cfg.prior.sample(generator, n_particles))
    prior_mean = (state.weights, state.locations)
    cfg.model.projection_count = 0
    _sync(device)
    t0 = time.perf_counter()
    state, true = run_loop(cfg, state, n_steps, generator)
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
    }


def profiled_run(cfg, n_particles, n_steps, seed, device, path):
    """One more run under :mod:`torch.profiler` (see
    :func:`qinfer_tpu_torch.bench.profile_device_time`)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = SMCState.initial(cfg.prior.sample(generator, n_particles))
    return profile_device_time(
        lambda: run_loop(cfg, state, n_steps, generator), device, path)


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
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions of the "
                        "kernels); the result names the CPU")
    parser.add_argument("--profile", metavar="PATH",
                        help="after the timed runs, profile one more run "
                        "and write its device time by kernel to PATH")
    for flag in NOT_PORTED:
        parser.add_argument("--" + flag.replace("_", "-"), nargs="?",
                            const=True, default=None, help="not ported yet")
    args = parser.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet")
    return args


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
    cfg = make_config(mode, device, args.process_qubits, args.qubits,
                      args.diffusion_rate)
    n, steps = args.particles, args.steps

    timed_run(cfg, n, steps, 1000 * args.seed, device)
    runs = [timed_run(cfg, n, steps, 1000 * args.seed + rep + 1, device)
            for rep in range(N_REPEATS)]
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
        "value": n * steps / best,
        "fidelity": min(fids),
        "fidelities": fids,
        "prior_fidelities": [r["prior_fidelity"] for r in runs],
        "resamples": [r["state"].resample_count for r in runs],
        "projections": [r["projections"] for r in runs],
        "wall_s": best,
        "repeat_walls_s": walls,
        "ok": ok,
    }
    if args.profile:
        wall, device_s = profiled_run(cfg, n, steps,
                                      1000 * args.seed + N_REPEATS + 1,
                                      device, args.profile)
        result.update(profiled_wall_s=wall, profiled_device_s=device_s,
                      device_idle_share=1.0 - device_s / best)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
