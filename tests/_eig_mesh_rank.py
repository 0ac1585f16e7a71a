"""One rank of ``test_torch_eig_mesh.py``: BASELINE config 5's step over a
particle mesh that spans the ranks of a gloo group on the CPU.

    python tests/_eig_mesh_rank.py --rank R --world 4 \
        --init file:///tmp/x/store --out /tmp/x

From one seeded uniform prior of the whole ensemble (each rank keeps its
block): six updates that do not resample, PGH's time and 16
candidates ``geomspace(0.25, 4, 16)`` times it scored by expected
information gain with the mesh's reducer, one update at the best
candidate that does not resample, and one that does (the two-level
Liu-West resampler). The
sequence runs twice, with the port's recording off and then on. Writes
``rank<R>.pt``: this rank's rows of each state, the scores, the
experiments, and what the recording saw.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from qinfer_tpu_torch import tracing  # noqa: E402
from qinfer_tpu_torch.distributions import UniformDistribution  # noqa: E402
from qinfer_tpu_torch.heuristics import PGH  # noqa: E402
from qinfer_tpu_torch.parallel import DistributedLiuWestResampler, \
    ParticleMesh  # noqa: E402
from qinfer_tpu_torch.parallel.mesh import reducer_of, \
    shard_state  # noqa: E402
from qinfer_tpu_torch.smc import SMCState, _expected_information_gain, \
    _update_step, score_candidates  # noqa: E402
from qinfer_tpu_torch.test_models import SimplePrecessionModel  # noqa: E402

TRUTH = 0.7
#: updates that shape the prior into a posterior before the scored step
WARM = 6
#: Liu-West's a: config 5 has 0.98, whose kernel adds 1 − a² = 4 % of the
#: posterior's variance, within the sampling tolerance of 16 384 draws; at
#: 0.9 it adds 19 %, so a resampler that drops the shrinkage toward the
#: mean reads a variance 19 % high
A = 0.9


def sequence(mesh, n, seed):
    """The scored step and its two updates from the seed's prior: a dict
    of this rank's tensors."""
    sharding = mesh.particle_sharding
    reducer = reducer_of(sharding)
    model = SimplePrecessionModel()
    resampler = DistributedLiuWestResampler(mesh, a=A, maxiter=10)
    gen = torch.Generator().manual_seed(seed)
    lab = random.Random(seed)
    state = shard_state(SMCState.initial(
        UniformDistribution([[0.0, 1.0]]).sample(gen, n)), sharding)
    pgh = PGH(types.SimpleNamespace(model=model, sharding=sharding))

    def run(state, t, thresh):
        p0 = np.cos(TRUTH * t / 2) ** 2
        outcome = int(lab.random() >= p0)
        new, _, _ = _update_step(
            model, resampler, state, torch.tensor([outcome]),
            {"t": torch.tensor([t], dtype=torch.float32)}, thresh, 1e-10,
            gen, reducer=reducer)
        return new, outcome

    for k in range(WARM):
        t = float(pgh.propose(gen, state.weights, state.locations,
                              k)["t"][0])
        state, _ = run(state, t, 0.0)
    out = {"w0": state.weights.clone(), "x0": state.locations.clone()}
    base = pgh.propose(gen, state.weights, state.locations, WARM)["t"][0]
    cand = base * torch.as_tensor(np.geomspace(0.25, 4.0, 16),
                                  dtype=torch.float32)
    eig = score_candidates(_expected_information_gain, model, state.weights,
                           state.locations, {"t": cand}, reducer=reducer)
    t_a = float(cand[torch.argmax(eig)])
    state, o_a = run(state, t_a, 0.0)
    out.update(cand=cand, eig=eig, t_a=t_a, o_a=o_a,
               w1=state.weights.clone(), x1=state.locations.clone())
    t_b = float(pgh.propose(gen, state.weights, state.locations,
                            WARM + 1)["t"][0])
    state, o_b = run(state, t_b, 1.0)
    out.update(t_b=t_b, o_b=o_b, w2=state.weights.clone(),
               x2=state.locations.clone(), resampled=state.just_resampled)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--particles", type=int, default=16384)
    p.add_argument("--seed", type=int, default=2718281829)
    args = p.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=args.init,
                            world_size=args.world, rank=args.rank)
    try:
        mesh = ParticleMesh.from_process_group(torch.device("cpu"))
        tracing.reset()
        off = sequence(mesh, args.particles, args.seed)
        off_snapshot = tracing.snapshot()
        calls0 = mesh.collective_calls
        with tracing.recording("cpu"):
            on = sequence(mesh, args.particles, args.seed)
        calls = mesh.collective_calls - calls0
        snap = tracing.snapshot()
        torch.save({"off": off, "on": on, "off_snapshot": off_snapshot,
                    "snapshot": snap, "collective_calls": calls, "a": A},
                   os.path.join(args.out, f"rank{args.rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
