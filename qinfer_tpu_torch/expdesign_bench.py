"""Experiment-design benchmark of the port (BASELINE config 5; counterpart
of ``benchmarks/expdesign_bench.py``) on one CUDA device.

The precession model (``SimplePrecessionModel``), a uniform prior on
[0, 1], ``LiuWestResampler(a=0.98)``, 10⁷ particles. Each step:

1. PGH proposes a time t*;
2. the candidates ``geomspace(0.25, 4, C) · t*`` are scored by expected
   information gain (the (2, n, C) likelihood table and its contractions,
   ``--chunk`` candidates at a time when given);
3. the best candidate runs at the true ω = 0.7 and the posterior is
   updated: reweight, ESS check, Liu-West resample at ESS ≤ n/2 (kernel
   K3 fills the ancestors).

One warm-up run, then one timed run from the same prior ensemble and
seeds. Run with ``python -m qinfer_tpu_torch.expdesign_bench [--particles
N] [--steps K] [--candidates C] [--chunk c] [--virtual D]``. It refuses to
run without a CUDA device unless ``--cpu`` asks for the CPU. ``--virtual
D`` shards the ensemble over D shards of a mesh on that one device
(``ParticleMesh([device] * D)``), with n rounded down to a multiple of D
and the plain ``LiuWestResampler``, as the JAX benchmark does: the
sharding is a layout, so the run is the unsharded run of that n, to the
bit. Prints ONE JSON line, with ``peak_memory_bytes`` the device's peak
allocation in the timed run (null on the CPU) and ``mesh`` the shards and
distinct devices (null without ``--virtual``); exits 1 when the
posterior mean misses 0.7 by 0.05 or more.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

import numpy as np
import torch

from .bench import card_label
from .distributions import UniformDistribution
from .heuristics import PGH
from .parallel.mesh import ParticleMesh, placement, shard_state
from .resamplers import LiuWestResampler
from .smc import (SMCState, _expected_information_gain, _update_step,
                  score_candidates)
from .test_models import SimplePrecessionModel

TRUE_OMEGA = 0.7


def candidate_spread(n_candidates, device):
    """The candidates' factors on the proposed time: ``geomspace(0.25, 4,
    n_candidates)``, float32."""
    return torch.as_tensor(np.geomspace(0.25, 4.0, n_candidates),
                           dtype=torch.float32).to(device)


def run_loop(model, resampler, state, n_steps, spread, chunk, generator):
    """Drive ``n_steps`` designed steps from ``state`` on ``generator``
    (PGH, candidate scoring, the best candidate's outcome at ω = 0.7, the
    update) and return the final state."""
    dev = state.locations.device
    pgh = PGH(types.SimpleNamespace(model=model))
    true = torch.full((1, 1), TRUE_OMEGA, device=dev)
    for idx in range(n_steps):
        base = pgh.propose(generator, state.weights, state.locations, idx)
        cand = {"t": base["t"][0] * spread}
        eig = score_candidates(_expected_information_gain, model,
                               state.weights, state.locations, cand,
                               candidate_chunk=chunk or None)
        eps = {"t": cand["t"][torch.argmax(eig)].reshape(1)}
        outcome = model.simulate_experiment(generator, true, eps).reshape(-1)
        state, _, _ = _update_step(model, resampler, state, outcome[:1], eps,
                                   0.5, 1e-10, generator)
    return state


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(n_particles=10_000_000, n_steps=32, n_candidates=16, chunk=0,
              device=None, resampler=None, mesh=None):
    """The benchmark: a warm-up run, then the timed run, both from one
    prior ensemble (seed 0) with the run's generator seeded 1. ``chunk``
    (0: none) must divide ``n_candidates``; ``resampler`` defaults to
    ``LiuWestResampler(a=0.98)``. With a ``mesh`` (a
    :class:`~qinfer_tpu_torch.parallel.ParticleMesh`) the ensemble of
    ``n_particles`` rounded down to a multiple of its shards is sharded
    over it, on its device. Returns the result's dict, with the final
    ``state`` beside it."""
    sharding = mesh.particle_sharding if mesh is not None else None
    device = placement(device, sharding)
    if mesh is not None:
        n_particles = n_particles // mesh.n_devices * mesh.n_devices
    chunk = chunk if 0 < chunk < n_candidates else 0
    if chunk and n_candidates % chunk:
        raise ValueError("the candidates must be a multiple of the chunk")
    model = SimplePrecessionModel()
    resampler = resampler or LiuWestResampler(a=0.98)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    start = SMCState.initial(
        UniformDistribution([[0.0, 1.0]]).sample(g, n_particles))
    if sharding is not None:
        start = shard_state(start, sharding)
    spread = candidate_spread(n_candidates, device)

    def run():
        g.manual_seed(1)
        return run_loop(model, resampler, start, n_steps, spread, chunk, g)

    run()  # warm-up
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    final = run()
    _sync(device)
    wall = time.perf_counter() - t0
    est = float(final.weights @ final.locations[:, 0])
    return {
        "metric": "expdesign_eig_throughput",
        "particles": n_particles,
        "steps": n_steps,
        "candidates": n_candidates,
        "chunk": chunk,
        "particle_updates_per_s": n_particles * n_steps / wall,
        "candidate_scores_per_s": n_particles * n_steps * n_candidates
        / wall,
        "posterior_mean": est,
        "true": TRUE_OMEGA,
        "resamples": final.resample_count,
        "wall_s": wall,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "mesh": (None if mesh is None else
                 {"shards": mesh.n_devices,
                  "distinct_devices": len(set(mesh.devices))}),
        "ok": abs(est - TRUE_OMEGA) < 0.05,
        "state": final,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--particles", type=int, default=10_000_000)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--candidates", type=int, default=16)
    parser.add_argument("--chunk", type=int, default=0,
                        help="score the candidates this many at a time (0: "
                        "all at once)")
    parser.add_argument("--virtual", type=int, default=0, metavar="D",
                        help="shard the ensemble over D shards of a mesh on "
                        "the one device (0: no mesh)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU; the result names the CPU")
    args = parser.parse_args(argv)
    if args.cpu:
        device, device_name, card = torch.device("cpu"), "cpu", None
    elif not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    else:
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        device_name, card = torch.cuda.get_device_name(device), card_label()
    try:
        mesh = (ParticleMesh([device] * args.virtual) if args.virtual > 0
                else None)
        result = run_bench(args.particles, args.steps, args.candidates,
                           args.chunk, device, mesh=mesh)
    except ValueError as exc:
        raise SystemExit(str(exc))
    del result["state"]
    print(json.dumps({"impl": "torch", "device": device_name, "card": card,
                      **result}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
