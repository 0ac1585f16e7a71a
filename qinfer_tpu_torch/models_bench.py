"""BASELINE configs 2 and 3 on the port (counterpart of
``benchmarks/models_bench.py``), each conditioned by one
:meth:`SMCUpdater.batch_update` over a fixed record.

Config 2, "MultiCosineModel / Ramsey estimation with T2 decoherence
nuisance parameter, 50k particles": ``BinomialModel(RamseyModel())``, 20
shots an experiment on the time ladder ``min(1.2^k, 30)``, k < 32, repeated
``--repeats`` times, the truth (ω, Γ) = (0.71, 0.08), a uniform prior on
[0, 1] × [0, 0.5].

Config 3, "RandomizedBenchmarkingModel (0th-order AGF decay), posterior
over (p, A, B) with region estimation": ``BinomialModel(
RandomizedBenchmarkingModel())``, 25 shots an experiment on the 16
sequence lengths ``round(1.6^k)``, k = 1..16, repeated ``--repeats`` times,
the truth (0.95, 0.5, 0.5), a uniform prior on [0.8, 1] × [0.3, 0.7]²;
then the credible region and its MVEE on the posterior.

The record is drawn from ``np.random.default_rng(0)``, config 2's counts
first, as the JAX benchmark draws it, so both packages condition on the
same data. Each config: an updater seeded 7 (Liu-West a = 0.98, the ESS
checked every 5th step), one warm call, then the best of 3 timed calls,
each after ``reset()``. Prints one JSON line per config: ``value``
(particle updates/s), ``wall_s``, ``resamples``, ``max_z_vs_true`` (the
largest |mean − truth| / sd), ``est``, and for config 3 ``region_est``.

Run with ``python -m qinfer_tpu_torch.models_bench [--particles N]
[--repeats R] [--profile PATH] [--device cpu]``; the card by default,
where it refuses to run without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .bench import card_label, profile_device_time
from .config import DEFAULT_DEVICE, resolve_device
from .derived_models import BinomialModel
from .distributions import UniformDistribution
from .rb import RandomizedBenchmarkingModel
from .smc import SMCUpdater
from .test_models import RamseyModel

N_PARTICLES = 50_000
REPEATS = 8
SEED = 7
N_TIMED = 3


@dataclasses.dataclass
class Config:
    """One benchmark configuration and its record (host arrays)."""

    tag: str
    model: object
    prior: object
    eps: dict
    counts: np.ndarray
    true: np.ndarray
    names: list


def make_configs(repeats=REPEATS):
    """Configs 2 and 3 with their records, from ``default_rng(0)`` in the
    JAX benchmark's order."""
    rng = np.random.default_rng(0)

    n_shots = 20
    ladder = np.minimum(np.asarray([1.2 ** k for k in range(32)]), 30.0)
    ts = np.tile(ladder, repeats).astype(np.float32)
    true2 = np.array([0.71, 0.08])
    vis = np.exp(-true2[1] * ts)
    pr0 = vis * np.cos(true2[0] * ts / 2) ** 2 + (1 - vis) / 2
    counts2 = rng.binomial(n_shots, pr0)
    ramsey = Config(
        "ramsey_t2", BinomialModel(RamseyModel(), n_meas_max=n_shots),
        UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
        {"t": ts, "n_meas": np.full((len(ts),), n_shots, np.int32)},
        counts2, true2, ["omega", "Gamma"])

    n_shots = 25
    ms = np.tile(np.unique(np.round(1.6 ** np.arange(1, 17))),
                 repeats).astype(np.float32)
    true3 = np.array([0.95, 0.5, 0.5])  # (p, A, B)
    p_surv = np.clip(true3[1] * true3[0] ** ms + true3[2], 0.0, 1.0)
    counts3 = rng.binomial(n_shots, p_surv)
    rb = Config(
        "rb", BinomialModel(RandomizedBenchmarkingModel(),
                            n_meas_max=n_shots),
        UniformDistribution([[0.8, 1.0], [0.3, 0.7], [0.3, 0.7]]),
        {"m": ms, "n_meas": np.full((len(ms),), n_shots, np.int32)},
        counts3, true3, ["p", "A", "B"])
    return [ramsey, rb]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_config(cfg, n_particles, device, make_resampler=None,
               before_run=None, after_run=None, profile=None):
    """Time one config: one warm ``batch_update``, then ``N_TIMED`` timed
    ones, each after ``reset()``; ``before_run()`` runs just before and
    ``after_run(updater)`` just after each timed call. ``make_resampler()``
    gives the updater's resampler (default Liu-West a = 0.98). With
    ``profile`` (a path), one more call runs under the profiler. Returns
    ``(updater, record)``, the updater holding the last timed call's
    posterior."""
    u = SMCUpdater(cfg.model, n_particles, cfg.prior, seed=SEED,
                   resampler=make_resampler() if make_resampler else None,
                   device=device)
    eps = {k: torch.as_tensor(v, device=device) for k, v in cfg.eps.items()}
    outs = torch.as_tensor(cfg.counts, device=device)
    u.batch_update(outs, eps)  # warm-up
    walls = []
    for _ in range(N_TIMED):
        u.reset()
        if before_run is not None:
            before_run()
        _sync(device)
        t0 = time.perf_counter()
        u.batch_update(outs, eps)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        if after_run is not None:
            after_run(u)
    best = min(walls)
    n_exp = int(outs.shape[0])
    est = u.est_mean().cpu().numpy().astype(np.float64)
    sd = np.sqrt(np.diag(u.est_covariance_mtx().cpu().numpy())
                 .astype(np.float64))
    z = np.abs(est - cfg.true) / np.maximum(sd, 1e-12)
    rec = {
        "metric": f"{cfg.tag}_particle_updates_per_s",
        "n_particles": n_particles,
        "n_experiments": n_exp,
        "value": n_particles * n_exp / best,
        "wall_s": best,
        "repeat_walls_s": walls,
        "resamples": u.resample_count,
        "max_z_vs_true": float(z.max()),
        "est": {k: float(v) for k, v in zip(cfg.names, est)},
    }
    if profile is not None:
        prof = SMCUpdater(cfg.model, n_particles, cfg.prior, seed=SEED,
                          device=device)
        wall, device_s = profile_device_time(
            lambda: prof.batch_update(outs, eps), device, profile)
        rec.update(profiled_wall_s=wall, profiled_device_s=device_s,
                   device_idle_share=1.0 - device_s / best)
    return u, rec


def region_estimate(updater, level=0.95):
    """The config-3 call-out on a posterior: the credible set and its MVEE
    (``region_est_ellipsoid``), timed after one warm query. Returns the
    record's ``region_est`` entry."""
    updater.est_credible_region(level)
    t0 = time.perf_counter()
    pts = updater.est_credible_region(level)
    _, c = updater.region_est_ellipsoid(level)
    return {
        "credible_points": int(pts.shape[0]),
        "mvee_center": [float(v) for v in c],
        "wall_s": time.perf_counter() - t0,
    }


def run_bench(n_particles=N_PARTICLES, repeats=REPEATS,
              device=DEFAULT_DEVICE, profile=None, **hooks):
    """Configs 2 then 3 (:func:`run_config`, ``hooks`` passed on), and the
    region estimate on config 3's posterior. ``profile`` is a path: each
    config writes its profile beside it, tagged. Without a CUDA device,
    pass ``device="cpu"``: the default raises there. Returns ``[(updater,
    record), ...]``."""
    device = resolve_device(device)
    out = []
    for cfg in make_configs(repeats):
        path = None
        if profile is not None:
            p = Path(profile)
            path = p.with_name(f"{p.stem}_{cfg.tag}{p.suffix}")
        u, rec = run_config(cfg, n_particles, device, profile=path, **hooks)
        if cfg.tag == "rb":
            rec["region_est"] = region_estimate(u)
        out.append((u, rec))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--particles", type=int, default=N_PARTICLES)
    parser.add_argument("--repeats", type=int, default=REPEATS,
                        help="ladder repetitions (record length = repeats x "
                        "ladder)")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="where to run (default: the card)")
    parser.add_argument("--profile", metavar="PATH",
                        help="after the timed calls, profile one more call "
                        "of each config and write its device time by kernel "
                        "beside PATH (PATH's stem + _<config>)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 1
    if args.profile and device.type != "cuda":
        print("--profile measures the card", file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        name, card = torch.cuda.get_device_name(device), card_label()
    else:
        name, card = str(device), None
    for _, rec in run_bench(args.particles, args.repeats, device,
                            args.profile):
        print(json.dumps({"impl": "torch", "device": name, "card": card,
                          **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
