"""Trajectories through ``SMCUpdater.update`` with PGH designs on the
precession model (the port's headline path).

A frozen copy of ``qinfer_tpu_torch/bench.py``'s ``make_updater`` and
``run_loop``, cut into steps: each trajectory draws a fresh prior from its
seed (``SMCUpdater`` re-seeded), and each step draws the outcome at the
true ω, updates (reweight, ESS gate, Liu-West resample), proposes the next
time by PGH and reads it on the host. The outcomes are the traffic's: the
harness draws them on the host from the trajectory's seed with
Pr(0) = cos²(ω·t/2), where ``bench.py`` asked the program's
``simulate_experiment``, as a lab hands its outcomes in. Later edits of
``bench.py`` do not move this copy.
"""

from __future__ import annotations

from qinfer_tpu_torch.distributions import UniformDistribution
from qinfer_tpu_torch.heuristics import PGH
from qinfer_tpu_torch.ops.accelerated import AcceleratedPrecessionModel
from qinfer_tpu_torch.resamplers import LiuWestResampler
from qinfer_tpu_torch.smc import SMCUpdater
from qinfer_tpu_torch.test_models import SimplePrecessionModel

from perfbench.lib import checks
from perfbench.lib.lab import Lab, pr0
from perfbench.lib.proxy import resampler_for

MODELS = {"AcceleratedPrecessionModel": AcceleratedPrecessionModel,
          "SimplePrecessionModel": SimplePrecessionModel}


class Driver:
    kinds = ("update", "resample")

    def __init__(self, cell, device, rec):
        cfg, tr = cell.config, cell.traffic
        self.cfg = cfg
        self.device = device
        self.n = int(tr["particles"])
        self.n_local = self.n
        self.steps = int(tr["steps"])
        self.truth = float(cfg["truth"][0])
        self.model = MODELS[cfg["model"]]()
        self.prior = UniformDistribution([cfg["prior"]["bounds"]])
        rs = cfg["resampler"]
        self.resampler = resampler_for(
            LiuWestResampler(a=rs["a"], maxiter=rs["maxiter"]), rec)
        self.thresh = float(cfg["resample_threshold"])

    def trajectory(self, seed, rec, steps=None):
        steps = self.steps if steps is None else steps
        with rec.span("prior"):
            updater = SMCUpdater(self.model, self.n, self.prior,
                                 resample_thresh=self.thresh,
                                 resampler=self.resampler, seed=seed,
                                 device=self.device)
        pgh = PGH(updater)
        lab = Lab(seed)
        with rec.span("design"):
            eps = pgh(0)
        t = float(eps["t"].reshape(-1)[0])
        for idx in range(steps):
            cap = rec.capture.want(idx)
            if cap is not None:
                st = updater.state
                cap.data.update(step=idx, t=t, gated=True,
                                w0=st.weights.clone(),
                                x0=st.locations.clone())
            with rec.span("experiment"):
                outcome = lab.bit(pr0(self.truth, t))
            rec.start()
            with rec.span("update"):
                updater.update(outcome, eps)
            st = updater.state
            kind = "resample" if st.just_resampled else "update"
            cap = rec.capture.admits(cap, kind)
            if cap is not None:
                cap.data.update(outcome=outcome, w1=st.weights.clone(),
                                x1=st.locations.clone())
            rec.count("resamples", int(st.just_resampled))
            with rec.span("design"):
                eps = pgh(idx + 1)
            t = float(eps["t"].reshape(-1)[0])
            rec.capture.commit(cap, kind)
            rec.step(kind)
            yield kind

    def check(self, kept, control=False, generator=None):
        return checks.precession_steps(kept, self.cfg, self.n, control,
                                       generator=generator).numbers()
