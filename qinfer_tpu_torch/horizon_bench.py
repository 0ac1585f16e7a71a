"""Fidelity against the horizon on the resample-move process path, with
and without experiment design.

Runs ``tomography_bench``'s loop (:func:`tomography_bench.timed_run`) with
the flagship recipe (``--shots 64 --moves 8 --adapt --target-accept 0.14
--interval 4 --no-move-canonicalize``) in three variants: the uniform
pick (``noeig``), the design rescoring every 4th step and after each
resample (``eig4``: ``--eig --eig-policy egreedy --eig-interval 4``) and
the design rescoring every step (``eig1``), and reads the fidelity of the
posterior mean every ``--every`` steps (one device→host copy there).

Run with ``python -m qinfer_tpu_torch.horizon_bench [--particles 50000]
[--steps 4000] [--steps-eig1 1000] [--seeds 1 2 3]``. It refuses to run
without a CUDA device unless ``--cpu`` asks for the CPU. Prints one JSON
line a run: the variant, the seed, the wall, the resamples, the mean
acceptance, the final log scale and ``fid``, the fidelity by step.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import tomography_bench as tb

RECIPE = ("--process --shots 64 --moves 8 --adapt --target-accept 0.14 "
          "--interval 4 --no-move-canonicalize")
VARIANTS = {"noeig": "",
            "eig4": " --eig --eig-policy egreedy --eig-interval 4",
            "eig1": " --eig --eig-policy egreedy --eig-interval 1"}


def run(variant, seed, n_particles, n_steps, every, device,
        process_qubits=2):
    """One timed run of ``variant``; the fidelity is read at every
    ``every``-th step and at the end."""
    args = tb.parse_args((RECIPE + VARIANTS[variant]).split())
    cfg = tb.make_config("process", device, process_qubits,
                         design=tb.design_from_args(args))
    fid = {}
    propose = cfg.propose

    def reading(generator, idx, weights, locations, scores=None):
        if idx and idx % every == 0:
            fid[idx] = tb.fidelity(cfg.model, locations, weights,
                                   cfg.true_mps)
        return propose(generator, idx, weights, locations, scores)

    cfg.propose = reading
    r = tb.timed_run(cfg, n_particles, n_steps, seed, device,
                     tb.moves_from_args(args))
    fid[n_steps] = r["fidelity"]
    return {"variant": variant, "seed": seed, "wall_s": r["wall_s"],
            "resamples": r["state"].resample_count,
            "acc": r["mean_move_acceptance"], "ls": r["final_log_scale"],
            "fid": fid}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--particles", type=int, default=50_000)
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--steps-eig1", type=int, default=1000)
    parser.add_argument("--every", type=int, default=250)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--process-qubits", type=int, default=2)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    else:
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        for variant in VARIANTS:
            steps = args.steps_eig1 if variant == "eig1" else args.steps
            print(json.dumps(run(variant, seed, args.particles, steps,
                                 args.every, device, args.process_qubits)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
