"""Weak scaling of the port over a particle mesh (counterpart of
``benchmarks/scaling.py``): particle-updates/s at D shards against one.

The port holds every shard of a mesh in one process, so the D shards of
a run share one device (``ParticleMesh([device] * D)``, a virtual mesh,
as ``scaling.py --virtual D`` forces D CPU devices). The "efficiency"
``rate(D) / (D · rate(1))`` therefore measures how the one device takes
D times the particles (and, on the precession leg, the two-level
resampler's exchange), not scaling across devices.

* Precession leg (default): ``SimplePrecessionModel``, a uniform prior on
  [0, 1], the truth ω = 0.7, ``--particles-per-device`` (262 144) times D
  particles, ``--steps`` (32) steps of a PGH proposal, the outcome and
  the update with the ESS checked every step; at D > 1 the resampler is
  ``DistributedLiuWestResampler(a=0.98)`` (``--exchange``: auto, ring or
  butterfly), at D = 1 the plain ``LiuWestResampler(a=0.98)``.
* ``--flagship``: two-qubit state tomography (15 parameters) of
  0.75·Bell + 0.25·I/4, Ginibre prior, 8 shots an experiment chosen from
  the 15 Pauli projectors by expected information gain
  (``policy='auto'``, every step), the compressed record, 4 adaptive MALA
  moves after each resample and ``LiuWestResampler(a=0.98, maxiter=4,
  canonicalize=False)``; ``--particles-per-device`` 8192 (at most
  16 384, as the JAX leg) times D, ``--steps`` 150 (at most 200). The
  sharding is a layout there, as in the JAX leg: the resampler is the
  plain one, and the run at D shards is the unsharded run of D times
  the particles. It reports the fidelity of the posterior mean.

Each leg runs at D = 1 and at each D of ``--virtual`` (8 by default; a
comma list for a sweep), for ``--seeds`` K seeds (1 for the precession
leg, 3 for the flagship by default): seed s draws the prior from a
generator seeded 2s and the run from one seeded 2s + 1. One warm-up run
of a few steps builds the kernels first; each run is timed once between
two device synchronizations. ``--profile PATH`` runs seed 0 at each D
once more under the profiler for the device's idle share and writes its
device time by kernel beside PATH.

Run with ``python -m qinfer_tpu_torch.scaling_bench [--flagship]
[--virtual D[,D...]] [--seeds K] [--particles-per-device N] [--steps S]
[--exchange E] [--profile PATH] [--cpu]``; the card by default, where it
refuses to run without one. Prints ONE JSON line; exits 1 when a
flagship run reads a fidelity below 0.90 or a precession run's posterior
mean is not finite. The precession leg's 32 steps leave the mean 0.05 or
more from 0.7 in about one run of ten with either resampler (the mass on
an alias of ω), so its estimate is printed, not held.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from .bench import card_label, profile_device_time
from .config import resolve_device
from .distributions import UniformDistribution
from .heuristics import PGH
from .parallel import DistributedLiuWestResampler, ParticleMesh
from .parallel.mesh import shard_state
from .resamplers import LiuWestResampler
from .smc import SMCState, _update_step
from .test_models import SimplePrecessionModel
from . import tomography_bench as tb

TRUE_OMEGA = 0.7
#: the flagship leg's bar on the posterior mean's fidelity
FIDELITY_BAR = 0.90
WARMUP_STEPS = 4


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PrecessionLeg:
    """The weak-scaling precession leg."""

    name = "precession"

    def __init__(self, device, exchange="auto"):
        self.model = SimplePrecessionModel()
        self.prior = UniformDistribution([[0.0, 1.0]])
        self.device = device
        self.exchange = exchange
        self.pgh = PGH(types.SimpleNamespace(model=self.model))

    def resampler(self, mesh):
        if mesh.n_devices == 1:
            return LiuWestResampler(a=0.98)
        return DistributedLiuWestResampler(mesh, a=0.98,
                                           exchange=self.exchange)

    def start(self, generator, n):
        return SMCState.initial(self.prior.sample(generator, n))

    def run(self, state, mesh, n_steps, generator):
        model, rs = self.model, self.resampler(mesh)
        true = torch.full((1, 1), TRUE_OMEGA, device=self.device)
        for idx in range(n_steps):
            eps = self.pgh.propose(generator, state.weights, state.locations,
                                   idx)
            outcome = model.simulate_experiment(generator, true,
                                                eps).reshape(-1)
            state, _, _ = _update_step(model, rs, state, outcome[:1], eps,
                                       0.5, 1e-10, generator)
        return state

    def score(self, state):
        est = float(state.weights @ state.locations[:, 0])
        return {"est": est, "ok": math.isfinite(est)}


class FlagshipLeg:
    """The flagship recipe's leg (two-qubit state tomography)."""

    name = "flagship"

    def __init__(self, device):
        self.cfg = tb.make_config("state", device, qubits=2,
                                  design=tb.Design("auto", 0.1, 1))
        self.opts = tb.Moves(shots=8, moves=4, mcmc_method="mala",
                             adapt=True)
        self.device = device

    def start(self, generator, n):
        return SMCState.initial(self.cfg.prior.sample(generator, n))

    def run(self, state, mesh, n_steps, generator):
        return tb.run_loop(self.cfg, state, n_steps, generator,
                           self.opts)[0]

    def score(self, state):
        fid = tb.fidelity(self.cfg.model, state.locations, state.weights,
                          self.cfg.true_mps)
        return {"fidelity": fid, "ok": fid >= FIDELITY_BAR}


def one_run(leg, mesh, n, n_steps, seed, profile=None):
    """One run of ``leg`` on ``mesh`` with ``n`` particles: the prior from
    a generator seeded 2·seed, the run from one seeded 2·seed + 1, timed
    between two synchronizations; with ``profile`` (a path, on the card)
    the run once more under the profiler, its device time by kernel
    written to that path. Returns its record."""
    device = leg.device
    g = torch.Generator(device=device)
    g.manual_seed(2 * seed)
    start = shard_state(leg.start(g, n), mesh.particle_sharding)
    g.manual_seed(2 * seed + 1)
    _sync(device)
    t0 = time.perf_counter()
    final = leg.run(start, mesh, n_steps, g)
    _sync(device)
    wall = time.perf_counter() - t0
    out = {"shards": mesh.n_devices, "seed": seed, "particles": n,
           "wall_s": wall, "updates_per_s": n * n_steps / wall,
           "resamples": final.resample_count, **leg.score(final)}
    if profile is not None and device.type == "cuda":
        g.manual_seed(2 * seed + 1)
        _, device_s = profile_device_time(
            lambda: leg.run(start, mesh, n_steps, g), device, profile)
        out["device_idle_share"] = 1.0 - device_s / wall
    return out


def run_leg(leg, shard_counts, per_device, n_steps, seeds, profile=None):
    """Every run of a leg: a warm-up, then each seed at each D; with
    ``profile`` (a path) seed 0 at each D is profiled once more, its table
    written beside the path, tagged with the leg and D. Returns ``(runs,
    efficiency by D and seed)``."""
    device = leg.device
    one_run(leg, ParticleMesh([device]), per_device, WARMUP_STEPS, 0)
    runs = []
    for seed in range(seeds):
        for d in shard_counts:
            path = None
            if profile is not None and seed == 0:
                p = Path(profile)
                path = p.with_name(f"{p.stem}_{leg.name}_d{d}{p.suffix}")
            runs.append(one_run(leg, ParticleMesh([device] * d),
                                per_device * d, n_steps, seed, path))
    base = {r["seed"]: r["updates_per_s"] for r in runs if r["shards"] == 1}
    eff = {str(d): [r["updates_per_s"] / (d * base[r["seed"]]) for r in runs
                    if r["shards"] == d] for d in shard_counts}
    return runs, eff


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--flagship", action="store_true",
                        help="run the flagship recipe's leg")
    parser.add_argument("--virtual", default="8", metavar="D[,D...]",
                        help="shard counts to run beside D = 1")
    parser.add_argument("--particles-per-device", type=int, default=None,
                        help="particles a shard (262 144 precession, 8192 "
                        "flagship)")
    parser.add_argument("--steps", type=int, default=None,
                        help="steps (32 precession, 150 flagship)")
    parser.add_argument("--seeds", type=int, default=None,
                        help="seeds 0..K-1 (1 precession, 3 flagship)")
    parser.add_argument("--exchange", default="auto",
                        choices=["auto", "ring", "butterfly"],
                        help="the precession leg's block exchange")
    parser.add_argument("--profile", metavar="PATH",
                        help="profile seed 0 at each D once more for the "
                        "device's idle share, writing its device time by "
                        "kernel beside PATH (the card only)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    shard_counts = sorted({1} | {int(d) for d in args.virtual.split(",")})
    if args.flagship:
        leg = FlagshipLeg(device)
        per_device = min(args.particles_per_device or 8192, 1 << 14)
        n_steps = min(args.steps or 150, 200)
        seeds = args.seeds or 3
    else:
        leg = PrecessionLeg(device, args.exchange)
        per_device = args.particles_per_device or 262_144
        n_steps = args.steps or 32
        seeds = args.seeds or 1
    runs, eff = run_leg(leg, shard_counts, per_device, n_steps, seeds,
                        args.profile)
    result = {
        "metric": f"{leg.name}_scaling_efficiency",
        "impl": "torch",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": card_label() if device.type == "cuda" else None,
        "virtual_mesh": True,
        "distinct_devices": 1,
        "note": "every shard on one device: the efficiency measures how "
                "the device takes D times the particles, not scaling "
                "across devices",
        "particles_per_device": per_device,
        "steps": n_steps,
        "exchange": args.exchange if not args.flagship else None,
        "runs": runs,
        "efficiency": eff,
        "ok": all(r["ok"] for r in runs),
    }
    if args.flagship:
        by_d = {d: [r["fidelity"] for r in runs if r["shards"] == d]
                for d in shard_counts}
        result["fidelity_mean_sd"] = {
            str(d): [float(np.mean(f)), float(np.std(f, ddof=1))
                     if len(f) > 1 else 0.0] for d, f in by_d.items()}
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        sys.exit(1)
