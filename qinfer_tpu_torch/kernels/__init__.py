"""Build and load layer for the port's hand-written CUDA kernels.

All sources under ``qinfer_tpu_torch/csrc/*.cu`` are compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and linked into ONE shared library with a plain C interface,
which is loaded with :mod:`ctypes`. The build happens at first use, from
the sources in the checkout, into ``qinfer_tpu_torch/_build/`` (listed in
``.gitignore``); the library's file name carries a hash of the sources and
flags, so an edited source is never served by a stale build. Importing
this module builds nothing.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Wrappers (in :mod:`qinfer_tpu_torch.ops`) validate their
tensors with :func:`require_cuda` and pass pointers and the stream with
:func:`ptr` and :func:`stream_of`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build",
           "library", "check", "ptr", "stream_of", "require_cuda"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

#: one compile line for every kernel; no --use_fast_math and no flush to
#: zero (see precession.cu and jacobi.cu)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "qk_fused_precession_update": (
        [_VP, _LL, _VP, _VP, _F, _VP, _I, _LL, _VP, _VP, _VP, _LL, _VP],
        ctypes.c_int),
    "qk_fused_precession_scratch_words": ([], ctypes.c_int),
    "qk_precession_pr0": ([_VP, _LL, _VP, _VP, _LL, _LL, _VP], ctypes.c_int),
    "qk_streaming_resample_locations": (
        [_VP, _VP, _VP, _LL, _LL, _VP], ctypes.c_int),
    "qk_counting_pass": (
        [_VP, _LL, _LL, _VP, _I, _F, _LL, _F, _VP, _VP, _VP, _VP],
        ctypes.c_int),
    "qk_counting_pass_tile": ([], ctypes.c_int),
    "qk_jacobi_project": ([_VP, _VP, _LL, _I, _I, _F, _F, _VP], ctypes.c_int),
    "qk_jacobi_project_warp": (
        [_VP, _VP, _LL, _I, _I, _F, _F, _VP], ctypes.c_int),
    "qk_jacobi_eigh": ([_VP, _VP, _VP, _LL, _I, _I, _VP], ctypes.c_int),
    "qk_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def build():
    """Compile the kernels if no build of the current sources exists.

    :return: ``(library path, compiler log)``; the log holds ``ptxas``'s
        register and shared-memory report of each kernel.
    """
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    lib = BUILD_DIR / f"libqinfer_kernels-{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, log.read_text() if log.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}-{tag}.o" for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        for cmd, proc, text in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)
    text = "".join(logs)
    log.write_text(text)
    return lib, text


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(status, what):
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        msg = library().qk_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name, t, dtype, ndim, contiguous=True):
    """Validate one kernel argument; raise ``ValueError`` on a mismatch."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.ndim}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
