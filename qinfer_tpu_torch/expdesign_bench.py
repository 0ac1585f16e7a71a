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
from .parallel import DistributedLiuWestResampler
from .parallel.mesh import ParticleMesh, placement, reducer_of, shard_state
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


def run_loop(model, resampler, state, n_steps, spread, chunk, generator,
             sharding=None, record=None):
    """Drive ``n_steps`` designed steps from ``state`` on ``generator``
    (PGH, candidate scoring, the best candidate's outcome at ω = 0.7, the
    update) and return the final state. With the ``sharding`` of a mesh
    across processes, ``state`` is the rank's block and the sums over
    particles reduce over the ranks. A ``record`` list gains, after each
    step, ``(t, posterior mean, resample count)``: the two tensors stay
    on the device."""
    dev = state.locations.device
    reducer = reducer_of(sharding)
    pgh = PGH(types.SimpleNamespace(model=model, sharding=sharding))
    true = torch.full((1, 1), TRUE_OMEGA, device=dev)
    for idx in range(n_steps):
        base = pgh.propose(generator, state.weights, state.locations, idx)
        cand = {"t": base["t"][0] * spread}
        eig = score_candidates(_expected_information_gain, model,
                               state.weights, state.locations, cand,
                               candidate_chunk=chunk or None, reducer=reducer)
        eps = {"t": cand["t"][torch.argmax(eig)].reshape(1)}
        outcome = model.simulate_experiment(generator, true, eps).reshape(-1)
        state, _, _ = _update_step(model, resampler, state, outcome[:1], eps,
                                   0.5, 1e-10, generator, reducer=reducer)
        if record is not None:
            record.append((eps["t"][0], reducer.sum(
                state.weights @ state.locations[:, 0]), state.resample_count))
    return state


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(n_particles=10_000_000, n_steps=32, n_candidates=16, chunk=0,
              device=None, resampler=None, mesh=None, record=False):
    """The benchmark: a warm-up run, then the timed run, both from one
    prior ensemble (seed 0) with the run's generator seeded 1. ``chunk``
    (0: none) must divide ``n_candidates``; ``resampler`` defaults to
    ``LiuWestResampler(a=0.98)``. With a ``mesh`` (a
    :class:`~qinfer_tpu_torch.parallel.ParticleMesh`) the ensemble of
    ``n_particles`` rounded down to a multiple of its shards is sharded
    over it, on its device; on a mesh across processes every rank runs
    this with the same arguments, holds its own block, resamples with
    ``DistributedLiuWestResampler(mesh, a=0.98)`` by default (the plain
    Liu-West has no form across processes) and reports the same numbers.
    Returns the result's dict, with the final ``state`` (the rank's
    block) beside it; with ``record``, also the timed run's ``t``,
    posterior mean and resample count after each step (``t_record``,
    ``mean_record``, ``resample_record``), read at its end."""
    sharding = mesh.particle_sharding if mesh is not None else None
    device = placement(device, sharding)
    if mesh is not None:
        n_particles = n_particles // mesh.n_devices * mesh.n_devices
    chunk = chunk if 0 < chunk < n_candidates else 0
    if chunk and n_candidates % chunk:
        raise ValueError("the candidates must be a multiple of the chunk")
    model = SimplePrecessionModel()
    if resampler is None:
        resampler = (DistributedLiuWestResampler(mesh, a=0.98)
                     if mesh is not None and mesh.spans_processes
                     else LiuWestResampler(a=0.98))
    g = torch.Generator(device=device)
    g.manual_seed(0)
    start = SMCState.initial(
        UniformDistribution([[0.0, 1.0]]).sample(g, n_particles))
    if sharding is not None:
        start = shard_state(start, sharding)
    spread = candidate_spread(n_candidates, device)

    def run(steps=None):
        g.manual_seed(1)
        return run_loop(model, resampler, start, n_steps, spread, chunk, g,
                        sharding, steps)

    run()  # warm-up
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    steps = [] if record else None
    t0 = time.perf_counter()
    final = run(steps)
    _sync(device)
    wall = time.perf_counter() - t0
    reducer = reducer_of(sharding)
    est = float(reducer.sum(final.weights @ final.locations[:, 0]))
    var = float(reducer.sum(final.weights
                            @ (final.locations[:, 0] - est) ** 2))
    records = {} if steps is None else {
        "t_record": [float(t) for t, _, _ in steps],
        "mean_record": [float(m) for _, m, _ in steps],
        "resample_record": [c for _, _, c in steps]}
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
        "posterior_sd": max(var, 0.0) ** 0.5,
        "true": TRUE_OMEGA,
        "resamples": final.resample_count,
        "wall_s": wall,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "mesh": (None if mesh is None else
                 {"shards": mesh.n_devices,
                  "distinct_devices": len(set(mesh.devices))}),
        "ok": abs(est - TRUE_OMEGA) < 0.05,
        **records,
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
