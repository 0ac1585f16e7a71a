"""Trajectories of designed precession over a particle mesh that spans the
ranks of a process group, one rank a card: PGH proposes t*, the
candidates ``geomspace(lo, hi, C)·t*`` are scored by expected information
gain (``smc.score_candidates``), the best one runs at the true ω and the
engine's step (``smc._update_step``) updates with the sums over the
ranks and the two-level Liu-West resampler
(``parallel.DistributedLiuWestResampler``).

A frozen copy of ``qinfer_tpu_torch/expdesign_bench.py``'s ``run_loop``
and ``run_bench`` (BASELINE config 5), cut into steps: each trajectory
draws a fresh prior of the whole ensemble from its seed on every rank,
which keeps its own block, and each step ends when the next design's time
is read on the host. The outcomes are the traffic's: every rank draws the
same ones on the host from the trajectory's seed with Pr(0) =
cos²(ω·t/2), where ``expdesign_bench.py`` asked the program's
``simulate_experiment``. Later edits of ``expdesign_bench.py`` do not move
this copy.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from qinfer_tpu_torch.distributions import UniformDistribution
from qinfer_tpu_torch.heuristics import PGH
from qinfer_tpu_torch.parallel import DistributedLiuWestResampler
from qinfer_tpu_torch.parallel.mesh import reducer_of, shard_state
from qinfer_tpu_torch.smc import SMCState, _expected_information_gain, \
    _update_step, score_candidates
from qinfer_tpu_torch.test_models import SimplePrecessionModel

from perfbench.lib import checks
from perfbench.lib.lab import Lab, pr0
from perfbench.lib.proxy import resampler_for


class Driver:
    kinds = ("update", "resample")

    def __init__(self, cell, device, rec, mesh, side):
        cfg, tr = cell.config, cell.traffic
        self.cfg = cfg
        self.device = device
        self.mesh = mesh
        self.side = side
        self.sharding = mesh.particle_sharding
        self.reducer = reducer_of(self.sharding)
        self.n = int(tr["particles"]) // mesh.n_devices * mesh.n_devices
        self.n_local = self.n // mesh.n_devices
        self.steps = int(tr["steps"])
        self.truth = float(cfg["truth"][0])
        self.thresh = float(cfg["resample_threshold"])
        self.model = SimplePrecessionModel()
        self.prior = UniformDistribution([cfg["prior"]["bounds"]])
        rs = cfg["resampler"]
        self.resampler = resampler_for(DistributedLiuWestResampler(
            mesh, a=rs["a"], maxiter=rs["maxiter"]), rec)
        lo, hi = tr["candidate_spread"]
        self.spread = torch.as_tensor(
            np.geomspace(lo, hi, int(tr["candidates"])),
            dtype=torch.float32).to(device)

    def _design(self, rec, generator, pgh, state, idx):
        """The next experiment: ``(eps, candidates, scores)``."""
        with rec.span("design"):
            base = pgh.propose(generator, state.weights, state.locations,
                               idx)
        cand = {"t": base["t"][0] * self.spread}
        with rec.span("eig"):
            eig = score_candidates(_expected_information_gain, self.model,
                                   state.weights, state.locations, cand,
                                   reducer=self.reducer)
        return {"t": cand["t"][torch.argmax(eig)].reshape(1)}, cand, eig

    def trajectory(self, seed, rec, steps=None):
        steps = self.steps if steps is None else steps
        dev = self.device
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        with rec.span("prior"):
            state = shard_state(SMCState.initial(
                self.prior.sample(generator, self.n)), self.sharding)
        pgh = PGH(types.SimpleNamespace(model=self.model,
                                        sharding=self.sharding))
        lab = Lab(seed)
        eps, _, _ = self._design(rec, generator, pgh, state, 0)
        t = float(eps["t"][0])
        for idx in range(steps):
            cap = rec.capture.want(idx)
            if cap is not None:
                cap.data.update(step=idx, t=t, gated=True,
                                w0=state.weights.clone(),
                                x0=state.locations.clone())
            with rec.span("experiment"):
                outcome = lab.bit(pr0(self.truth, t))
                outcome_t = torch.tensor([outcome], device=dev)
            rec.start()
            with rec.span("update"):
                state, _, _ = _update_step(
                    self.model, self.resampler, state, outcome_t, eps,
                    self.thresh, 1e-10, generator, reducer=self.reducer)
            kind = "resample" if state.just_resampled else "update"
            cap = rec.capture.admits(cap, kind)
            rec.count("resamples", int(state.just_resampled))
            eps, cand, eig = self._design(rec, generator, pgh, state,
                                          idx + 1)
            if cap is not None:
                cap.data.update(outcome=outcome, w1=state.weights.clone(),
                                x1=state.locations.clone(),
                                cand=cand["t"].clone(), eig=eig.clone())
            t = float(eps["t"][0])
            rec.capture.commit(cap, kind)
            rec.step(kind)
            yield kind

    def check(self, kept, control=False, generator=None):
        rank = self.mesh.rank
        rows = torch.arange(rank * self.n_local, (rank + 1) * self.n_local)
        for caps in kept.values():
            for cap in caps:
                cap.data["rows"] = rows.to(self.device)
        tally = checks.precession_steps(
            kept, self.cfg, self.n, control, total=self.side.total,
            generator=generator, whole=self.side.whole)
        checks.eig_scores(tally, [c for caps in kept.values() for c in caps],
                          control, total=self.side.total)
        return tally.numbers()
