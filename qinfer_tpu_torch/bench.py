"""Headline benchmark of the port: particle-updates/s on the precession
model, on one CUDA device.

The same protocol as the JAX package's ``bench.py``: 2²² particles, 256
adaptive steps (PGH proposal → outcome simulated at the true ω = 0.7 →
SMC update with an ESS check every step and Liu-West resampling at half
the ensemble), one warm-up run (which also builds the kernels), three timed
repeats, the best taken, and the sanity check ``|est − 0.7| < 0.05``. The
model is :class:`~qinfer_tpu_torch.ops.accelerated.
AcceleratedPrecessionModel`, so each step runs kernels K1 (reweight) and
K2 (outcome simulation) and each resample runs K3 (fill). The loop runs
eagerly through :meth:`SMCUpdater.update`.

Run with ``python -m qinfer_tpu_torch.bench``. It refuses to run without a
CUDA device. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from .distributions import UniformDistribution
from .heuristics import PGH
from .ops.accelerated import AcceleratedPrecessionModel
from .resamplers import LiuWestResampler
from .smc import SMCUpdater

N_PARTICLES = 1 << 22
N_STEPS = 256
N_REPEATS = 3
TRUE_OMEGA = 0.7
BASELINE = 1e7  # north star: particle-updates/s/chip


def make_updater(n_particles, seed, device):
    """The benchmark's updater: AcceleratedPrecessionModel, uniform prior on
    [0, 1], Liu-West a = 0.98, resample threshold 0.5."""
    return SMCUpdater(AcceleratedPrecessionModel(), n_particles,
                      UniformDistribution([[0.0, 1.0]]),
                      resample_thresh=0.5, resampler=LiuWestResampler(a=0.98),
                      seed=seed, device=device)


def run_loop(updater, n_steps, seed):
    """Drive ``n_steps`` adaptive steps on ``updater``: PGH proposal, the
    outcome simulated at ω = 0.7 from a generator seeded with ``seed``, and
    the update."""
    model = updater.model
    pgh = PGH(updater)
    generator = torch.Generator(device=updater.device)
    generator.manual_seed(seed)
    true_omega = torch.full((1, 1), TRUE_OMEGA, dtype=torch.float32,
                            device=updater.device)
    for idx in range(n_steps):
        eps = pgh(idx)
        outcome = model.simulate_experiment(generator, true_omega, eps)
        updater.update(outcome, eps)
    return updater


def timed_run(n_particles, n_steps, seed, device):
    """One run: build the updater (prior sample, not timed), then time the
    loop between two device synchronizations. Returns ``(wall_s,
    updater)``."""
    updater = make_updater(n_particles, seed, device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run_loop(updater, n_steps, seed + 1000)
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0, updater


def profile_device_time(run, device, path=None):
    """Call ``run()`` once under :mod:`torch.profiler`, write the table of
    device time by kernel to ``path`` (when given) and return ``(wall_s,
    device_s)``: the profiled wall time and the device time summed over all
    kernels and copies (the profiler slows the host, so the wall is an
    upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device events only, as the profiler's own "Self CUDA time total"
    device_s = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation) / 1e6
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(events.table(sort_by="self_device_time_total",
                                           row_limit=40))
    return wall, device_s


def profiled_run(n_particles, n_steps, seed, device, path):
    """One more run under :mod:`torch.profiler` (see
    :func:`profile_device_time`)."""
    updater = make_updater(n_particles, seed, device)
    return profile_device_time(
        lambda: run_loop(updater, n_steps, seed + 1000), device, path)


def parse_refusing(parser, argv, not_ported):
    """``parser.parse_args(argv)``, taking the JAX benchmark's flags named
    in ``not_ported`` (with or without a value) only to refuse them."""
    for flag in not_ported:
        parser.add_argument("--" + flag.replace("_", "-"), nargs="?",
                            const=True, default=None, help="not ported yet")
    args = parser.parse_args(argv)
    for flag in not_ported:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet")
    return args


def card_label():
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--particles", type=int, default=N_PARTICLES)
    parser.add_argument("--profile", metavar="PATH",
                        help="after the timed runs, profile one more run and "
                        "write its device time by kernel to PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    timed_run(args.particles, N_STEPS, 0, device)  # warm-up and build
    walls, updater = [], None
    for rep in range(N_REPEATS):
        wall, updater = timed_run(args.particles, N_STEPS, rep + 1, device)
        walls.append(wall)
    best = min(walls)
    rate = args.particles * N_STEPS / best
    est = float(updater.est_mean()[0])
    ok = abs(est - TRUE_OMEGA) < 0.05
    if not ok:
        print(f"WARNING: benchmark posterior mean {est:.4f} != 0.7",
              file=sys.stderr)
    result = {
        "metric": "particle_updates_per_s_per_chip",
        "value": rate,
        "unit": "particle-updates/s/chip",
        "vs_baseline": rate / BASELINE,
        "impl": "torch",
        "device": torch.cuda.get_device_name(device),
        "card": card_label(),
        "particles": args.particles,
        "steps": N_STEPS,
        "repeat_walls_s": walls,
        "resample_count": updater.resample_count,
        "est": est,
        "ok": ok,
    }
    if args.profile:
        wall, device_s = profiled_run(args.particles, N_STEPS,
                                      N_REPEATS + 1, device, args.profile)
        result.update(profiled_wall_s=wall, profiled_device_s=device_s,
                      device_idle_share=1.0 - device_s / best)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
