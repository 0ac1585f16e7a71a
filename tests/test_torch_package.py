"""Structure of the port: it never imports JAX, importing it builds no
kernel, the kernel wrappers use their plain versions on CPU tensors only
(so their launch counters stay 0 here), and the CUDA sources keep the
accurate cosine."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import kernels
from qinfer_tpu_torch.ops import (counting_pass, jacobi, precession,
                                  streaming_resample)

PKG = Path(qt.__file__).resolve().parent
ROOT = PKG.parent


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, qinfer_tpu_torch, qinfer_tpu_torch.bench, "
            "qinfer_tpu_torch.convert, qinfer_tpu_torch.kernels, "
            "qinfer_tpu_torch.tomography, "
            "qinfer_tpu_torch.tomography_bench, qinfer_tpu_torch.expdesign, "
            "qinfer_tpu_torch.expdesign_bench, "
            "qinfer_tpu_torch.finite_difference, "
            "qinfer_tpu_torch.horizon_bench, qinfer_tpu_torch.rb, "
            "qinfer_tpu_torch.simple_est, qinfer_tpu_torch.models_bench, "
            "qinfer_tpu_torch.item8_bench, qinfer_tpu_torch.trials_bench, "
            "qinfer_tpu_torch.checkpoint, qinfer_tpu_torch.clustering, "
            "qinfer_tpu_torch.metrics, qinfer_tpu_torch.ipy, "
            "qinfer_tpu_torch._due, qinfer_tpu_torch.version, "
            "qinfer_tpu_torch.tomography.plotting_tools, "
            "qinfer_tpu_torch.parallel, qinfer_tpu_torch.scaling_bench; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'qinfer_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_module_of_the_port_imports_jax():
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "qinfer_tpu"), (
                    f"{path.relative_to(ROOT)} imports {name}")


def test_import_builds_nothing():
    assert kernels.library.cache_info().currsize == 0


def test_launch_counters_stay_zero_on_cpu():
    wrappers = (precession.fused_precession_update, precession.precession_pr0,
                streaming_resample.streaming_resample_locations,
                jacobi.jacobi_project_lanes,
                jacobi.jacobi_project_lanes_looped, jacobi.jacobi_eigh_lanes,
                counting_pass.counting_multiplicities_from_u)
    for fn in wrappers:
        fn.launches = 0
    _, extra = qt.perf_test(qt.AcceleratedPrecessionModel(), 2048,
                            qt.UniformDistribution([[0.0, 1.0]]), 30,
                            true_mps=[[0.7]], seed=4, device="cpu")
    assert extra["updater"].resample_count > 0
    from qinfer_tpu_torch import tomography_bench as tb
    cfg = tb.make_config("process", torch.device("cpu"), 1)
    run = tb.timed_run(cfg, 300, 40, 0, torch.device("cpu"))
    assert run["projections"] > 0
    assert [fn.launches for fn in wrappers] == [0] * 7
    assert kernels.library.cache_info().currsize == 0


def test_cuda_sources_carry_their_notes_and_the_accurate_cosine():
    sources = {p.name: p.read_text() for p in kernels.CSRC_DIR.glob("*.cu")}
    assert set(sources) == {"precession.cu", "streaming_resample.cu",
                            "jacobi.cu", "counting_pass.cu"}
    for fn in ("jacobi_project_lanes", "jacobi_project_lanes_looped",
               "jacobi_eigh_lanes"):
        assert f"qinfer_tpu/ops/jacobi.py::{fn}" in sources["jacobi.cu"]
    # the Jacobi kernel rounds every step explicitly: no contraction
    assert "__fmul_rn" in sources["jacobi.cu"]
    assert "qinfer_tpu/ops/precession.py::fused_precession_update" in (
        sources["precession.cu"])
    assert "qinfer_tpu/ops/precession.py::precession_pr0" in (
        sources["precession.cu"])
    assert ("qinfer_tpu/ops/streaming_resample.py::"
            "streaming_resample_locations") in sources["streaming_resample.cu"]
    # the counting pass replaces no Pallas kernel, names what it replaces
    # and rounds the plain version's ops one by one
    counting = sources["counting_pass.cu"]
    assert "Replaces no Pallas kernel" in counting
    assert "qinfer_tpu/resamplers.py:164" in counting
    assert "__fdiv_rn" in counting and "__fmul_rn" in counting
    assert "streaming_resample_kernel" not in counting
    assert "__cosf(" not in sources["precession.cu"]
    assert "cosf(" in sources["precession.cu"]
    assert not any("fast_math" in f or "fast-math" in f
                   for f in kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_plain_versions_run_on_cpu_tensors():
    omega = torch.linspace(0.0, 1.0, 7)
    w = torch.full((7,), 1.0 / 7)
    h, norm, ess, mean = precession.fused_precession_update(
        omega, w, 2.0, 0, normalize=False)
    want = w.numpy() * np.cos(omega.numpy() * 1.0) ** 2
    np.testing.assert_allclose(h.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(float(norm), want.sum(), rtol=1e-6)
    pr0 = precession.precession_pr0(omega[:1], torch.tensor([2.0, 4.0]))
    assert pr0.shape == (1, 2)
    m = torch.tensor([0, 3, 0, 1], dtype=torch.int32)
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = streaming_resample.streaming_resample_locations(
        m, torch.tensor([0, 0, 3, 3], dtype=torch.int32), x)
    np.testing.assert_array_equal(out.numpy(), [[2, 3], [2, 3], [2, 3],
                                                [6, 7]])


def test_parallel_names_are_exported():
    """The three names the JAX package re-exports from its ``parallel``
    module, and the module's own."""
    from qinfer_tpu_torch import parallel

    for name in ("ParticleMesh", "make_particle_sharding",
                 "DirectViewParallelizedModel"):
        assert name in qt.__all__ and getattr(qt, name) is getattr(parallel,
                                                                    name)
    assert set(parallel.__all__) >= {
        "ParticleMesh", "make_particle_sharding", "initialize_multihost",
        "DirectViewParallelizedModel", "DistributedLiuWestResampler",
        "shard_systematic_ancestors", "butterfly_exchange_schedule"}
    assert "parallel" in qt.__all__
