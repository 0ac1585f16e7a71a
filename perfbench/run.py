#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernels' build into the checkout, the model, one
short warm-up trajectory of the cell's own shapes), then trajectories
back to back for ``--seconds``, then the correctness check of the window's
captured steps against the plain reference, then ONE JSON line on
standard output (the check's numbers, each beside its limit, as the last
lines on standard error). ``--trace 1`` runs the window under
``torch.profiler`` and reports the per-layer metrics instead of the
end-to-end ones. Needs as many CUDA cards as the cell asks for: without
them it exits 2 and prints no result. A cell of several cards starts one
rank a card (``--rank`` and the options after it are the ranks' own).

``--control`` adds the readings of the control (the reference in TF32 in
the program's place) on the same captured steps; ``--cpu`` rehearses a run
on the CPU for the tests, with no device metric in its line; ``--plant
module:function`` calls that function before the run's set-up, in each
process that runs the window (the tests plant faults in the program with
it).
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.lib import env  # noqa: E402

CHILD_ENV = env.prepare()

import torch  # noqa: E402

from perfbench.lib import cells, report  # noqa: E402
from perfbench.lib.capture import Reservoir  # noqa: E402
from perfbench.lib.kernels import Observer  # noqa: E402
from perfbench.lib.window import Recorder, run_window, sync, \
    trajectory_seed  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--plant")
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--init")
    p.add_argument("--out")
    p.add_argument("--t0", type=float)
    return p.parse_args(argv)


def card_power_limit():
    """``name, power.limit`` of each card as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return "; ".join(out.stdout.strip().splitlines()) or out.stderr.strip()


def plant(spec):
    """Call ``module:function`` (``--plant``)."""
    import importlib

    module, function = spec.split(":")
    getattr(importlib.import_module(module), function)()


def measure(args, cell, device, t0, mesh=None, side=None):
    """Set-up, the window and the check in this process (one rank of a
    cell over cards, or the whole of a one-card cell): its summary."""
    traced = bool(args.trace)
    if args.plant:
        plant(args.plant)
    if device.type == "cuda":
        from qinfer_tpu_torch import kernels

        kernels.library()
    # PyTorch's default, kept: float32 products without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = cells.driver(cell)
    rec = Recorder(device, Reservoir(args.seed, 0), traced)
    extra = () if mesh is None else (mesh, side)
    driver = mod.Driver(cell, device, rec, *extra)
    observer = Observer().install() if traced else None
    warm = int(cell.traffic["warmup_steps"])
    for _ in driver.trajectory(trajectory_seed(args.seed, 1 << 30), rec,
                               steps=warm):
        pass
    sync(device)
    if observer is not None:
        for calls in observer.calls.values():
            calls.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec.capture = Reservoir(args.seed, cell.traffic["captures"],
                            driver.kinds)
    agree = None if side is None else side.any
    counters0 = _counters(mesh)
    if side is not None:
        side.barrier()
    prof = None
    if traced:
        from perfbench.lib.trace import profiler

        prof = profiler(device)
        prof.__enter__()
    setup_s = time.time() - t0
    window_s, steps, trajectories = run_window(
        driver, args.seed, args.seconds, rec, device, agree)
    summary = {}
    if prof is not None:
        from perfbench.lib.trace import summarize

        prof.__exit__(None, None, None)
        summary["trace"] = summarize(prof, rec.host_spans)
        del prof
    if observer is not None:
        observer.remove()
        summary["calls"] = {
            k: [len(v), float(sum(observer.kernels[k].bound_s(c)
                                  for c in v))]
            for k, v in observer.calls.items()}
    counters1 = _counters(mesh)
    summary["counters"] = {k: counters1[k] - counters0[k] for k in counters0}
    step_s = rec.step_seconds()
    kinds = rec.step_kinds()
    summary.update(
        setup_s=setup_s, window_s=window_s, steps=steps,
        trajectories=trajectories, n=driver.n, n_local=driver.n_local,
        step_s=step_s.tolist(),
        kinds={k: kinds.count(k) for k in sorted(set(kinds))},
        counts=rec.counts,
        spans={k: [len(v), float(v.sum())] for k, v in
               rec.span_seconds().items()},
        memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0),
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
        tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kept = rec.capture.kept()
    summary["captured"] = {k: len(v) for k, v in kept.items()}
    summary["cloned"] = rec.capture.cloned
    gen = torch.Generator(device=device)
    gen.manual_seed(trajectory_seed(args.seed, 1 << 31))
    summary["numbers"] = driver.check(kept, generator=gen)
    if args.control:
        summary["control"] = driver.check(kept, control=True, generator=gen)
    summary["forbidden"] = env.forbidden_modules()
    return summary


def _counters(mesh):
    if mesh is None:
        return {}
    return {"collective_calls": float(mesh.collective_calls),
            "collective_seconds": float(mesh.collective_seconds)}


def rank_main(args, cell):
    """One rank of a cell over cards: NCCL over its card (gloo on the CPU),
    its summary written to ``--out``."""
    import torch.distributed as dist

    from qinfer_tpu_torch.parallel.mesh import ParticleMesh, \
        initialize_multihost
    from perfbench.lib.ranks import Side

    if args.cpu:
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=args.init,
                                world_size=args.world, rank=args.rank)
        mesh = ParticleMesh.from_process_group(device)
    else:
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        initialize_multihost(args.init, args.world, args.rank,
                             backend="nccl")
        mesh = ParticleMesh()
    side = Side()
    try:
        summary = measure(args, cell, device, args.t0, mesh, side)
        out = Path(args.out) / f"rank{args.rank}.json"
        out.write_text(json.dumps(summary))
        side.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None):
    args = parse(argv)
    cell = cells.load_cell(args.workload)
    if args.rank is not None:
        return rank_main(args, cell)
    if not args.cpu:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    card = None if args.cpu else card_power_limit()
    if cell.chips > 1:
        from perfbench.lib.ranks import launch

        if not args.cpu:
            # build the kernels once, before the ranks start
            from qinfer_tpu_torch import kernels

            kernels.build()
        passed = ["--workload", args.workload, "--seed", str(args.seed),
                  "--seconds", str(args.seconds), "--trace", str(args.trace),
                  "--t0", repr(T0)] + (["--control"] if args.control else [])
        if args.plant:
            passed += ["--plant", args.plant]
        summaries = launch(passed, cell.chips, CHILD_ENV, cpu=args.cpu)
    else:
        device = torch.device("cpu" if args.cpu else "cuda")
        summaries = [measure(args, cell, device, T0)]
    found = sorted(set(env.forbidden_modules()).union(
        *[s["forbidden"] for s in summaries]))
    if found:
        print(f"modules that must not load were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    line, checks_lines = report.result(cell, summaries, args, card)
    for text in checks_lines:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
