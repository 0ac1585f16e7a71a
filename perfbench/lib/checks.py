"""The numbers that decide ``correct``, from the captured steps.

Each captured step's inputs (the weights and locations it started from,
its experiment and outcome) go to the plain reference (``reference/``),
which works the step out again; the program's outputs are judged against
that, never against the program's own intermediates. With ``control`` the
reference computed in TF32 (:mod:`perfbench.reference.precision`) stands in
the program's place: its outputs are judged the same way, which is how
the limits were shown to fail it.

``total`` sums a partial over the ranks of a cell that spans cards (the
identity in one process); every number is the whole ensemble's.

The numbers:

* ``weights_l1``: Σ|w − w_ref| of a step that did not resample, the
  worst captured step (the update layer: likelihood, reweight,
  normalization; across cards the sums over ranks);
* ``invariant_errors``: captured steps that break an exact rule: a
  resample verdict against the reference's ESS gate (outside a band of
  1e-4·n around the threshold), locations that moved on a step that did
  not resample, resampled weights not 1/n, a non-finite value, a state
  outside the model's domain after the step;
* ``resample_ks``: √n times the Kolmogorov distance between the resampled
  cloud and the law of the Liu-West resample of the reference's posterior
  (one parameter);
* ``psd_violation``: the most negative least eigenvalue of a resampled
  state, sign reversed (the strict projection);
* ``resample_mean_z``, ``resample_var_gap``: the resampled cloud against
  the reference's Liu-West resample (with its validity rounds and strict
  projection) of the reference's posterior from the same start: the
  largest gap of a coordinate's mean, in standard errors of the
  difference, and the relative gap of the total variance (many
  parameters);
* ``accept_z``, ``moved_z``, ``moves_z``: the moves' mean acceptance, the
  share of particles they moved, and the record log-likelihood's mean
  after them, against the reference's moves from the same start, in
  standard errors of the difference;
* ``eig_gap``: the scores' largest gap to the reference's, over the
  largest reference score.
"""

from __future__ import annotations

import math

import torch

from ..reference import precession as P
from ..reference import smc as S
from ..reference.precision import FLOAT64, TF32

#: the ESS gate's band: no verdict is judged this close to the threshold
GATE_BAND = 1e-4
#: points of the Kolmogorov distance's grid
KS_POINTS = 129


one_process = S.one_process


class Tally:
    """The numbers of one run: each the worst over the captured steps."""

    def __init__(self):
        self.values = {}
        self.errors = []

    def worst(self, name, value):
        value = float(value)
        if not math.isfinite(value):
            value = float("inf")
        self.values[name] = max(self.values.get(name, 0.0), value)

    def error(self, what):
        self.errors.append(what)

    def numbers(self):
        out = dict(self.values)
        out["invariant_errors"] = float(len(self.errors))
        return out


def finite(*tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def gate_verdict(tally, ess, n, resampled, gated, where):
    """The resample verdict against the reference's ESS gate."""
    if not gated:
        if resampled:
            tally.error(f"{where}: resampled on a step the gate skips")
        return
    ess = float(ess)
    if abs(ess - 0.5 * n) <= GATE_BAND * n:
        return
    if resampled != (ess <= 0.5 * n):
        tally.error(f"{where}: resampled={resampled}, reference ESS "
                    f"{ess:.6g} against threshold {0.5 * n:.6g}")


def l1(a, b, total=one_process):
    return float(total((a.to(torch.float64) - b.to(torch.float64))
                       .abs().sum()))


def uniform_weights(tally, w, n, where, total=one_process):
    target = torch.tensor(1.0 / n, dtype=torch.float32)
    off = total((w.to(torch.float32).cpu() != target).sum()
                .to(torch.float64))
    if float(off):
        tally.error(f"{where}: {int(float(off))} resampled weights are not "
                    f"1/n")


def float32_midpoints(grid):
    """Each point moved to the middle between two neighbouring float32
    values: there a float32 cloud's empirical CDF equals that of the values
    before they were rounded to float32 (near ω = 0.7 its spacing, 6e-8, is
    a tenth of a late step's Liu-West kernel, and would read as a
    distance)."""
    lo = grid.to(torch.float32)
    lo = torch.where(lo.to(torch.float64) > grid,
                     torch.nextafter(lo, torch.full_like(lo, -math.inf)), lo)
    hi = torch.nextafter(lo, torch.full_like(lo, math.inf))
    return 0.5 * (lo.to(torch.float64) + hi.to(torch.float64))


def ks_precession(x_new, w_ref, x_old, a, maxiter, n, total=one_process):
    """√n · the Kolmogorov distance of the resampled cloud ``x_new`` (this
    rank's rows) from the Liu-West law of (w_ref, x_old), on a grid of
    :data:`KS_POINTS` quantiles of the law's moments."""
    mu, cov = S.moments(w_ref, x_old.to(torch.float64), FLOAT64, total)
    var = float(cov[0, 0])
    p = torch.linspace(0.002, 0.998, KS_POINTS, dtype=torch.float64,
                       device=w_ref.device)
    grid = float(mu[0]) + math.sqrt(max(var, 1e-300)) * torch.special.ndtri(p)
    grid = float32_midpoints(grid)
    law = total(P.liu_west_cdf(grid, w_ref, x_old, float(mu[0]), var, a,
                               maxiter))
    xs = torch.sort(x_new[:, 0].to(torch.float64)).values
    below = torch.searchsorted(xs, grid, right=True).to(torch.float64)
    emp = total(below) / n
    return math.sqrt(n) * S.ks_distance(emp, law)


def cloud_gap(x, ref):
    """``(mean_z, var_gap)`` of the cloud ``x`` against the reference's
    cloud ``ref`` (two independent draws of one law): the largest gap of a
    coordinate's mean over the standard error of the difference, and
    |Σ var(x) − Σ var(ref)| / Σ var(ref)."""
    x = x.to(torch.float64)
    ref = ref.to(torch.float64)
    vx, vr = x.var(dim=0), ref.var(dim=0)
    se = torch.sqrt(vx / x.shape[0] + vr / ref.shape[0]).clamp_min(1e-300)
    mean_z = float(((x.mean(dim=0) - ref.mean(dim=0)).abs() / se).max())
    var_gap = abs(float(vx.sum() - vr.sum())) / max(float(vr.sum()), 1e-300)
    return mean_z, var_gap


def precession_steps(kept, cfg, n, control=False, total=one_process,
                     generator=None, whole=None):
    """The numbers of a precession cell's captured steps. ``kept`` maps a
    kind to its captures, each with ``w0``, ``x0`` (this rank's rows
    before the step), ``t``, ``outcome``, ``w1``, ``x1`` (after it) and
    ``gated``. With ``control`` the step's outputs are the TF32
    reference's; ``whole(tensor)`` gathers the ensemble's rows in one
    process, for the control's resample over cards."""
    a = float(cfg["resampler"]["a"])
    maxiter = int(cfg["resampler"]["maxiter"])
    tally = Tally()
    for kind, caps in kept.items():
        for cap in caps:
            d = cap.data
            where = f"{kind} step {d['step']}"
            w0 = d["w0"].to(torch.float64)
            x0 = d["x0"].to(torch.float64)
            lik = P.likelihood(x0[:, 0], d["t"], d["outcome"], FLOAT64)
            w_ref, ess = S.reweight(w0, lik, FLOAT64, total)
            w1, x1 = d["w1"], d["x1"]
            resampled = kind != "update"
            if control:
                lik_c = P.likelihood(d["x0"][:, 0], d["t"], d["outcome"],
                                     TF32)
                w1, _ = S.reweight(d["w0"], lik_c, TF32, total)
                x1 = d["x0"]
                if resampled:
                    w_all = whole(w1) if whole else w1
                    x_all = whole(d["x0"]) if whole else d["x0"]
                    x1 = P.resample(generator, w_all, x_all, a, maxiter,
                                    TF32)
                    if whole:
                        x1 = x1[d["rows"]]
                    w1 = torch.full_like(w1, 1.0 / n)
            if not finite(w1, x1):
                tally.error(f"{where}: non-finite weights or locations")
                continue
            if not control:
                gate_verdict(tally, ess, n, resampled, d["gated"], where)
            if float(total((x1[:, 0] < 0).sum().to(torch.float64))):
                tally.error(f"{where}: a frequency below 0")
            if not resampled:
                tally.worst("weights_l1", l1(w1, w_ref, total))
                if not torch.equal(x1, d["x0"]):
                    tally.error(f"{where}: locations moved without a "
                                f"resample")
                continue
            uniform_weights(tally, w1, n, where, total)
            tally.worst("resample_ks", ks_precession(
                x1, w_ref, x0, a, maxiter, n, total))
    return tally


def eig_scores(tally, caps, control=False, total=one_process):
    """``eig_gap`` of the captured design scores: each capture holds the
    state scored (``w1``, ``x1``, this rank's rows), the candidate times
    ``cand`` and the program's scores ``eig``."""
    for cap in caps:
        d = cap.data
        w = d["w1"].to(torch.float64)
        x = d["x1"][:, 0].to(torch.float64)
        times = d["cand"].to(torch.float64)
        marg, cond = P.eig_partials(w, x, times, FLOAT64)
        ref = P.eig_from_partials(total(marg), total(cond))
        got = d["eig"].to(torch.float64)
        if control:
            mc, cc = P.eig_partials(d["w1"], d["x1"][:, 0], d["cand"], TF32)
            got = P.eig_from_partials(total(mc.to(torch.float64)),
                                      total(cc.to(torch.float64)))
        scale = float(ref.abs().max())
        tally.worst("eig_gap", float((got - ref).abs().max())
                    / max(scale, 1e-300))


def moves_numbers(tally, proc, d, record, rule, generator, control=False):
    """The moves of one captured event against the reference's moves from
    the same start, scale and sweep count (``record`` is ``(succ,
    trials, pool effects)``):

    * ``accept_z``: the sweeps' mean acceptance against the reference's, in
      standard errors of the difference;
    * ``moved_z``: the share of particles that the sweeps moved against
      the reference's, in standard errors of the difference;
    * ``moves_z``: the record log-likelihood's mean over the moved cloud
      against the reference's, in standard errors of the difference."""
    succ, trials, pool_e = record

    def loglik(ar):
        return lambda y: proc.record_loglik(y, succ, trials, pool_e, ar)

    args = (d["sweeps"], d["log_scale"], d["adapt_t"], rule)
    ref, acc_ref = proc.moves(generator, d["x1"], loglik(FLOAT64), *args,
                              FLOAT64)
    x_moved, acc = d["x2"], d["accept"]
    if control:
        x_moved, acc = proc.moves(generator, d["x1"], loglik(TF32), *args,
                                  TF32)
    n = ref.shape[0]
    trials_n = n * max(int(d["sweeps"]), 1)
    p = min(max(acc_ref, 1.0 / trials_n), 1.0 - 1.0 / trials_n)
    tally.worst("accept_z", abs(acc - acc_ref)
                / math.sqrt(2.0 * p * (1.0 - p) / trials_n))
    start = d["x1"].to(torch.float64)
    moved = float((x_moved.to(torch.float64) != start).any(dim=1)
                  .to(torch.float64).mean())
    moved_ref = float((ref != start).any(dim=1).to(torch.float64).mean())
    q = min(max(0.5 * (moved + moved_ref), 1.0 / n), 1.0 - 1.0 / n)
    tally.worst("moved_z", abs(moved - moved_ref)
                / math.sqrt(2.0 * q * (1.0 - q) / n))
    lp = loglik(FLOAT64)(x_moved.to(torch.float64))
    lr = loglik(FLOAT64)(ref)
    se = math.sqrt(float(lp.var() + lr.var()) / n)
    tally.worst("moves_z", abs(float(lp.mean() - lr.mean()))
                / max(se, 1e-300))


def tomography_steps(kept, cfg, proc, pool_e, n, control=False,
                     generator=None, rule=None):
    """The numbers of a tomography cell's captured steps. Each capture
    holds ``w0``, ``x0``, ``pool`` (the experiment's row of the pool),
    ``outcome``, ``shots``, ``gated``, ``w1``, ``x1``; a ``move`` capture
    also ``x2`` (after the moves), their mean acceptance ``accept``, the
    record ``succ``, ``trials`` the moves targeted, and the adaptation's
    ``log_scale`` and ``adapt_t`` they started from."""
    a = float(cfg["resampler"]["a"])
    maxiter = int(cfg["resampler"]["maxiter"])
    tally = Tally()
    for kind, caps in kept.items():
        for cap in caps:
            d = cap.data
            where = f"{kind} step {d['step']}"
            e = pool_e[d["pool"]]
            lik = proc.likelihood(d["x0"], e, d["outcome"], d["shots"],
                                  FLOAT64)
            w_ref, ess = S.reweight(d["w0"].to(torch.float64), lik, FLOAT64)
            w1, x1 = d["w1"], d["x1"]
            resampled = kind != "update"
            if control:
                lik_c = proc.likelihood(d["x0"], e, d["outcome"],
                                        d["shots"], TF32)
                w1, _ = S.reweight(d["w0"], lik_c, TF32)
                x1 = d["x0"]
                if resampled:
                    x1 = proc.resample(generator, w1, d["x0"], a, maxiter,
                                       TF32)
                    w1 = torch.full_like(w1, 1.0 / n)
            if not finite(w1, x1):
                tally.error(f"{where}: non-finite weights or locations")
                continue
            if not control:
                gate_verdict(tally, ess, n, resampled, d["gated"], where)
            if not resampled:
                tally.worst("weights_l1", l1(w1, w_ref))
                if not torch.equal(x1, d["x0"]):
                    tally.error(f"{where}: locations moved without a "
                                f"resample")
                continue
            uniform_weights(tally, w1, n, where)
            tally.worst("psd_violation",
                        max(0.0, -float(proc.least_eig(x1).min())))
            ref_x = proc.resample(generator, w_ref, d["x0"], a, maxiter,
                                  FLOAT64)
            mean_z, var_gap = cloud_gap(x1, ref_x)
            tally.worst("resample_mean_z", mean_z)
            tally.worst("resample_var_gap", var_gap)
            if kind != "move":
                continue
            moves_numbers(tally, proc, d, (d["succ"], d["trials"], pool_e),
                          rule, generator, control)
            if not control:
                low = float(proc.least_eig(d["x2"]).min())
                if low < -proc.psd_tol * (1.0 + 1e-3) - 1e-6:
                    tally.error(f"{where}: a moved state's least "
                                f"eigenvalue {low:.3g} is below "
                                f"-{proc.psd_tol}")
    return tally
