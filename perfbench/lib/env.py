"""What a run sets before it imports torch: the checkout's root on the
import path, every build and kernel cache at a fixed directory inside the
checkout, and the interpreter's own state kept out of the measurement.
Importing this module changes nothing; :func:`prepare` does."""

from __future__ import annotations

import os
import sys
from pathlib import Path

#: the checkout's root (the directory that holds ``perfbench/``)
ROOT = Path(__file__).resolve().parents[2]
#: the caches the harness and the program may write, inside the checkout
CACHE = ROOT / ".perfbench_cache"

#: top-level module names that must never be loaded in a run: the JAX
#: package the port was made from, JAX itself, and the old TPU benchmark
FORBIDDEN = ("jax", "jaxlib", "flax", "qinfer_tpu", "benchmarks")


def prepare():
    """Put the checkout first on ``sys.path`` and fix the caches; returns
    the environment to hand to child processes."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    fixed = {
        "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
        "TRITON_CACHE_DIR": CACHE / "triton",
        "CUDA_CACHE_PATH": CACHE / "cuda",
    }
    for key, path in fixed.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    # one thread for the host's own arithmetic: the card does the work,
    # and fewer threads keep the host's share of a run steady
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def forbidden_modules(modules=None):
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot) is one of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split(".", 1)[0] in FORBIDDEN})
