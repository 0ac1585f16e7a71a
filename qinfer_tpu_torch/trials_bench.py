"""Trial-parallel adaptive inference throughput (counterpart of
``benchmarks/trials_bench.py``): many independent precession trials
through :func:`~qinfer_tpu_torch.perf_testing.perf_test_scan_batch`.

The configuration of the JAX benchmark: ``SimplePrecessionModel``, a
uniform prior on [0, 1], PGH, Liu-West a = 0.98 at half the ensemble,
``--trials`` x ``--particles`` x ``--steps`` (32 x 131 072 x 256 by
default), seed 11, the ESS checked every ``--interval``-th step (every
step for 0). Modes:

* ``baseline``: one trial on a one-device mesh, the per-trial reference;
* ``sequential``: every trial on a one-device mesh, one after another,
  each with its own branching;
* ``batched``: every trial at once on one device; a step resamples only
  the trials whose ESS fell, with one K3 launch over their rows.

Each run is one warm call of the runner, then one timed call between two
device synchronizations, then (on the card) one more call under the
profiler for the device's idle share; ``--profile PATH`` writes that
call's device time by kernel beside PATH, tagged with the mode and the
interval. One JSON line per run: JAX's fields
(aggregate and per-trial updates/s, wall, the median |estimate − truth|
at the last step, the median ratio of the last step's loss to the
first's) and ``resamples_per_trial``, ``k3_launches`` (of the timed
call) and ``device_idle_share`` (1 − profiled device time / timed wall;
null on the CPU). The JAX benchmark's ``--fill`` chose among TPU fill
strategies: the port has one fill, K3, so the flag is refused.

Run with ``python -m qinfer_tpu_torch.trials_bench [--trials T]
[--particles N] [--steps S] [--modes baseline,sequential,batched]
[--interval K] [--profile PATH] [--cpu]``; the card by default, where
it refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .bench import card_label, profile_device_time
from .config import resolve_device
from .distributions import UniformDistribution
from .ops import streaming_resample as sr
from .parallel import ParticleMesh
from .perf_testing import perf_test_scan_batch
from .resamplers import LiuWestResampler
from .test_models import SimplePrecessionModel

SEED = 11
MODES = ("baseline", "sequential", "batched")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def summarize(record, wall, tag, n_trials, n, n_exp, interval):
    """JAX's fields of one timed run."""
    est = record["est"][:, -1, :].cpu().numpy()
    true = record["true_mps"].cpu().numpy()
    loss = record["loss"].cpu().numpy()
    return {
        "metric": f"trials_{tag}_aggregate_updates_per_s",
        "resample_interval": interval,
        "n_trials": n_trials,
        "n_particles": n,
        "n_steps": n_exp,
        "value": n_trials * n * n_exp / wall,
        "per_trial_updates_per_s": n * n_exp / wall,
        "wall_s": wall,
        "median_abs_err_final": float(np.median(np.abs(est - true))),
        "median_loss_ratio_final_vs_first": float(np.median(
            loss[:, -1] / np.maximum(loss[:, 0], 1e-30))),
    }


def run(tag, n_trials, n, n_exp, interval, device, mesh, profile=None):
    """One warm and one timed call of the mode's runner (and one profiled
    call on the card, its table written to ``profile`` when given);
    returns the JSON record."""
    runner, seeds = perf_test_scan_batch(
        SimplePrecessionModel(), n, UniformDistribution([[0.0, 1.0]]),
        n_exp, n_trials, resampler=LiuWestResampler(a=0.98), seed=SEED,
        mesh=mesh, resample_interval=interval, return_runner=True,
        device=device)
    runner(seeds)
    _sync(device)
    sr.streaming_resample_locations.launches = 0
    t0 = time.perf_counter()
    record = runner(seeds)
    _sync(device)
    wall = time.perf_counter() - t0
    k3 = sr.streaming_resample_locations.launches
    out = summarize(record, wall, tag, n_trials, n, n_exp, interval)
    out.update(resamples_per_trial=runner.resample_counts, k3_launches=k3,
               device_idle_share=None)
    if device.type == "cuda":
        _, device_s = profile_device_time(lambda: runner(seeds), device,
                                          profile)
        out["device_idle_share"] = 1.0 - device_s / wall
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trials", type=int, default=32)
    parser.add_argument("--particles", type=int, default=2 ** 17)
    parser.add_argument("--steps", type=int, default=256)
    parser.add_argument("--modes", default=",".join(MODES),
                        help="comma list of " + "|".join(MODES))
    parser.add_argument("--interval", type=int, default=0,
                        help="check the ESS every K-th step (0: every "
                        "step)")
    parser.add_argument("--profile", metavar="PATH",
                        help="write each mode's profiled call's device time "
                        "by kernel beside PATH (the card only)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--fill", nargs="?", const=True, default=None,
                        help="refused: the JAX benchmark's TPU fill "
                        "strategies")
    args = parser.parse_args(argv)
    if args.fill is not None:
        raise SystemExit("--fill is refused: the TPU fill strategies "
                         "(pallas, scan, telescope) are left out on "
                         "purpose; the port has one fill, kernel K3")
    modes = args.modes.split(",")
    unknown = sorted(set(modes) - set(MODES))
    if unknown:
        raise SystemExit(f"unknown mode(s) {unknown}: choose from {MODES}")
    device = resolve_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    card = card_label() if device.type == "cuda" else "cpu"
    mesh1 = ParticleMesh([device], axis_name="trials")
    results = []
    for mode in modes:
        n_trials = 1 if mode == "baseline" else args.trials
        tag = "baseline1" if mode == "baseline" else mode
        profile = None
        if args.profile:
            p = Path(args.profile)
            profile = p.with_name(f"{p.stem}_{tag}_i{args.interval}"
                                  f"{p.suffix}")
        out = run(tag, n_trials, args.particles, args.steps, args.interval,
                  device, None if mode == "batched" else mesh1, profile)
        out["card"] = card
        print(json.dumps(out), flush=True)
        results.append(out)
    return results


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        sys.exit(1)
