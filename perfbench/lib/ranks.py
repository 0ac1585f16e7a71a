"""A cell that spans cards: one rank a card, started by the parent run.

The ranks meet at a ``file://`` store in a fresh directory under
``TMPDIR``; the program's mesh runs over NCCL (gloo on the CPU, where a
test rehearses a run), and the harness keeps a gloo group of its own for
what is not the program's: the agreement on the window's end, once a
trajectory, and the reference's sums over the ranks. Each rank writes its
summary to a file; the parent waits for every rank, stops any that
outlives the run's limit, and combines them."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: seconds the parent waits for its ranks
RANK_TIMEOUT_S = 330


class Side:
    """The harness's own gloo group over the ranks."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo")

    def total(self, x):
        """The sum over the ranks of ``x`` (a tensor or number), on the
        device ``x`` is on."""
        t = torch.as_tensor(x)
        out = t.detach().to("cpu", torch.float64 if t.is_floating_point()
                            else torch.int64).clone()
        dist.all_reduce(out, group=self.group)
        return out.to(t.device, t.dtype if t.is_floating_point()
                      else torch.float64)

    def whole(self, x):
        """The ensemble's rows in mesh order from each rank's ``x``."""
        local = x.detach().cpu().contiguous()
        parts = [torch.empty_like(local) for _ in
                 range(dist.get_world_size())]
        dist.all_gather(parts, local, group=self.group)
        return torch.cat(parts).to(x.device)

    def any(self, flag):
        t = torch.tensor([1 if flag else 0], dtype=torch.int64)
        dist.all_reduce(t, group=self.group, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self):
        dist.barrier(group=self.group)


def launch(argv, world, env, cpu=False):
    """Start ``world`` ranks of ``perfbench/run.py`` with ``argv`` and wait
    for them; returns each rank's summary. A rank that fails or outlives
    :data:`RANK_TIMEOUT_S` fails the run, and every rank is stopped before
    this returns."""
    run_py = Path(__file__).resolve().parents[1] / "run.py"
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-ranks-",
                                dir=os.environ.get("TMPDIR")))
    cmd = [sys.executable, str(run_py), *argv, "--world", str(world),
           "--init", f"file://{tmp}/store", "--out", str(tmp)]
    if cpu:
        cmd.append("--cpu")
    # the cards talk over NVLink; NCCL's shared-memory transport, which
    # would write under /dev/shm, stays off
    env = dict(env, NCCL_SHM_DISABLE="1")
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    failed = None
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                if p.poll() is not None:
                    pending.remove(p)
                    if p.returncode != 0 and failed is None:
                        failed = procs.index(p)
            if failed is not None or time.perf_counter() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if failed is not None or any(p.returncode != 0 for p in procs):
        r = failed if failed is not None else next(
            i for i, p in enumerate(procs) if p.returncode != 0)
        raise RuntimeError(f"rank {r} exited {procs[r].returncode}:\n"
                           f"{outs[r][-6000:]}")
    summaries = []
    for r in range(world):
        path = tmp / f"rank{r}.json"
        if not path.is_file():
            raise RuntimeError(f"rank {r} wrote no summary:\n"
                               f"{outs[r][-6000:]}")
        summaries.append(json.loads(path.read_text()))
    for path in tmp.iterdir():
        path.unlink()
    tmp.rmdir()
    return summaries
