"""Trajectories of adaptive process tomography through the engine's step
(``smc._update_step``) and, after each resample, adaptive Metropolis
moves on the pool's sufficient statistics
(``rejuvenation.mcmc_rejuvenate_binomial_adaptive``).

A frozen copy of ``qinfer_tpu_torch/tomography_bench.py``'s
``process_config`` and ``run_loop`` (the process mode, the sufficient
record, the adaptive random walk), cut into steps: each trajectory draws
a fresh prior from its seed, and each step draws the outcome (a bit, or
a count of ``shots``) at the true channel, updates with the ESS gate
every ``interval``-th step, runs the moves after a resample, draws the
next (prep, meas) pair uniformly from the pool and reads its row on the
host. The outcomes are the traffic's: the harness draws them on the host
from the trajectory's seed with the truth's Born probability of each
pair, worked out by the plain reference, where ``tomography_bench.py``
asked the program's ``simulate_experiment``. Later edits of
``tomography_bench.py`` do not move this copy.
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import reduce

import numpy as np
import torch

from qinfer_tpu_torch import rejuvenation as rj
from qinfer_tpu_torch import tomography as tomo
from qinfer_tpu_torch.derived_models import BinomialModel
from qinfer_tpu_torch.resamplers import LiuWestResampler
from qinfer_tpu_torch.smc import SMCState, _update_step, \
    resample_interval_gate

from perfbench.lib import checks
from perfbench.lib.lab import Lab
from perfbench.lib.proxy import resampler_for
from perfbench.reference.precision import FLOAT64
from perfbench.reference.tomography import Process


def fiducial_kets(nq):
    """The 4^nq tetrahedral product preparations (and measurements)."""
    kets1 = np.asarray(
        [[1, 0], [0, 1],
         [1 / np.sqrt(2), 1 / np.sqrt(2)],
         [1 / np.sqrt(2), 1j / np.sqrt(2)]], dtype=np.complex64)
    return [reduce(np.kron, combo)
            for combo in itertools.product(kets1, repeat=nq)]


def depolarizing_choi(dd, p_dep):
    """The normalized Choi state of the depolarizing-``p_dep`` channel."""
    J_id = np.zeros((dd * dd, dd * dd), dtype=np.complex64)
    for mm in range(dd):
        for nn in range(dd):
            E = np.zeros((dd, dd), dtype=np.complex64)
            E[mm, nn] = 1
            J_id += np.kron(E, E)
    return ((1 - p_dep) * J_id
            + p_dep * np.kron(np.eye(dd), np.eye(dd) / dd)) / dd


class Driver:
    def __init__(self, cell, device, rec):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.device = device
        nq = int(cfg["qubits"])
        dd = 2 ** nq
        b1 = tomo.pauli_basis(nq)
        b2 = tomo.pauli_basis(2 * nq)
        self.base = tomo.ProcessTomographyModel(b2, b1)
        self.prior = tomo.BCSZChoiDistribution(b2)
        self.proc = Process(nq, cfg["validity"]["psd_tol"],
                            cfg["validity"]["strict_tol"], device)
        self.pool_e = self.proc.pool_effects(fiducial_kets(nq))
        truth = self.proc.coords(depolarizing_choi(
            dd, float(cfg["truth"]["depolarizing"])))
        # the truth's Pr(0) of every (prep, meas) pair of the pool
        self.true_pr0 = self.proc.pr0(truth[None], self.pool_e,
                                      FLOAT64)[0].cpu().numpy()
        fid = torch.stack([b1.state_to_modelparams(np.outer(k, k.conj()))
                           for k in fiducial_kets(nq)]).to(device)
        self.n_fid = fid.shape[0]
        # the candidate pool: every (prep, meas) pair, row i·n_fid + j
        self.pool = {"prep": fid.repeat_interleave(self.n_fid, dim=0),
                     "meas": fid.repeat(self.n_fid, 1)}
        self.shots = int(tr["shots"])
        self.model = (BinomialModel(self.base, n_meas_max=self.shots)
                      if self.shots > 0 else self.base)
        self.shots_t = torch.full((1,), max(self.shots, 1),
                                  dtype=torch.int32, device=device)
        self.moves = int(tr["moves"])
        # every resample is followed by the moves where there are any
        self.kinds = ("update", "move" if self.moves > 0 else "resample")
        self.interval = int(tr["interval"])
        self.target = float(tr.get("target_accept", 0.234))
        rs = cfg["resampler"]
        # the resampler projects; the moves do not (--no-move-canonicalize)
        self.resampler = resampler_for(LiuWestResampler(
            a=rs["a"], maxiter=rs["maxiter"], canonicalize=True), rec)
        self.n = int(tr["particles"])
        self.n_local = self.n
        self.steps = int(tr["steps"])
        self.thresh = float(cfg["resample_threshold"])

    def _propose(self, generator):
        """A (prep, meas) pair drawn uniformly: its pool row (1,)."""
        i = torch.randint(0, self.n_fid, (1,), generator=generator,
                          device=self.device)
        j = torch.randint(0, self.n_fid, (1,), generator=generator,
                          device=self.device)
        return i * self.n_fid + j

    def trajectory(self, seed, rec, steps=None):
        steps = self.steps if steps is None else steps
        dev = self.device
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        with rec.span("prior"):
            state = SMCState.initial(self.prior.sample(generator, self.n))
        n_pool = self.pool["prep"].shape[0]
        succ = torch.zeros((n_pool,), dtype=torch.int32, device=dev)
        trials = torch.zeros((n_pool,), dtype=torch.int32, device=dev)
        log_scale = rj.initial_log_scale(int(self.model.n_modelparams),
                                         "rwm", None)
        adapt_t = 0
        lab = Lab(seed)
        with rec.span("design"):
            row = self._propose(generator)
        row_host = int(row)
        for idx in range(steps):
            eps = {k: v[row] for k, v in self.pool.items()}
            if self.shots > 0:
                eps = dict(eps, n_meas=self.shots_t)
            cap = rec.capture.want(idx)
            gate = resample_interval_gate(idx, self.interval)
            if cap is not None:
                cap.data.update(step=idx, pool=row_host, shots=self.shots,
                                gated=gate is None or bool(gate),
                                w0=state.weights.clone(),
                                x0=state.locations.clone())
            with rec.span("experiment"):
                k = lab.count(self.true_pr0[row_host], self.shots)
                outcome = torch.tensor([k], device=dev)
            rec.start()
            with rec.span("update"):
                state, _, _ = _update_step(
                    self.model, self.resampler, state, outcome[:1], eps,
                    self.thresh, 1e-10, generator, check_resample=True,
                    resample_gate=gate)
            # success := underlying outcome 0 (a count with shots)
            if self.shots > 0:
                succ.index_add_(0, row, outcome[:1].to(torch.int32))
            else:
                succ.index_add_(0, row, (outcome[:1] == 0).to(torch.int32))
            trials.index_add_(0, row, self.shots_t)
            kind = "update"
            if state.just_resampled:
                kind = "move" if self.moves > 0 else "resample"
                rec.count("resamples")
            cap = rec.capture.admits(cap, kind)
            if cap is not None:
                cap.data.update(outcome=k, w1=state.weights.clone(),
                                x1=state.locations.clone())
            if kind == "move":
                if cap is not None:
                    cap.data.update(succ=succ.clone(), trials=trials.clone(),
                                    log_scale=torch.as_tensor(
                                        log_scale).clone(),
                                    adapt_t=torch.as_tensor(adapt_t).clone(),
                                    sweeps=self.moves)
                with rec.span("moves"):
                    x, accept, log_scale, adapt_t = (
                        rj.mcmc_rejuvenate_binomial_adaptive(
                            self.model, self.prior, generator,
                            state.locations, succ, trials, self.pool,
                            self.moves, log_scale, adapt_t, method="rwm",
                            target_accept=self.target, canonicalize=False,
                            adapt=True))
                state = dataclasses.replace(state, locations=x)
                if cap is not None:
                    cap.data.update(x2=x.clone(), accept=accept.clone())
            with rec.span("design"):
                row = self._propose(generator)
            row_host = int(row)
            rec.capture.commit(cap, kind)
            rec.step(kind)
            yield kind

    def check(self, kept, control=False, generator=None):
        for caps in kept.values():
            for cap in caps:
                d = cap.data
                for key in ("log_scale", "accept"):
                    if key in d:
                        d[key] = float(d[key])
                if "adapt_t" in d:
                    d["adapt_t"] = int(d["adapt_t"])
        rule = dict(self.cfg["moves_adaptation"], target=self.target)
        return checks.tomography_steps(kept, self.cfg, self.proc,
                                       self.pool_e, self.n,
                                       control, generator, rule).numbers()
