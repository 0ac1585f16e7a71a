#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port starts on a GPU.

Run from the root of a checkout with ``python3 chip_smoke.py`` on a
machine with one NVIDIA Hopper card. It drives the port
(``qinfer_tpu_torch``), never the JAX package, in phases; each phase prints
one line, and any failure exits non-zero without the final ``ok`` line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, nvcc;
2. build: compiles the hand-written kernels from ``qinfer_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (2²² particles; K2 also at n = 1, the shape the
   loop gives it), with the tolerance stated;
4. engine: 20 reweight steps on the card against the same steps run by the
   plain path on the CPU, and ``perf_test`` at 4096 particles;
5. main path: the benchmark protocol (2²² particles, 256 adaptive steps,
   ESS check every step, Liu-West resampling), with every kernel launch
   counter reset to 0 before and read after each run;
6. timing: each kernel's device time (torch.profiler) against its plain
   version's, after the main path so the profiler cannot slow the loop.

Then it prints the kernels' JSON line, the card line and, last,
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 1 << 22


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_ms(fn, reps=20):
    """Device time of one ``fn()`` in ms: every kernel and copy it runs,
    summed by the profiler over ``reps`` calls. The host's launch overhead
    is left out; inputs that fit the 50 MB L2 stay warm across calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation)
    require(us > 0, "the profiler saw no device time")
    return us / 1e3 / reps


def time_pair(kernel_fn, plain_fn):
    """Kernel and plain device times in turns (plain, kernel, kernel,
    plain); each the mean of its two readings."""
    p1 = device_ms(plain_fn)
    k1 = device_ms(kernel_fn)
    k2 = device_ms(kernel_fn)
    p2 = device_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_kernels(torch, dev):
    """Phase 3: each kernel against its plain version at main-path shapes.

    Returns one ``(result, kernel_fn, plain_fn)`` per kernel, at the shape
    the main path launches it with (K2 at n = 1: the true model inside
    ``simulate_experiment``), and ``(label, kernel_fn, plain_fn)`` for
    shapes timed besides (K2 at n = 2²²). The timing itself runs after the
    main path (:func:`time_kernels`), so that the profiler cannot slow the
    timed loop."""
    from qinfer_tpu_torch.ops import precession as prec
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.resamplers import counting_multiplicities_from_u

    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n = N_MAIN
    omega = torch.rand((n,), generator=g, device=dev)
    w = torch.rand((n,), generator=g, device=dev)
    w = w / w.sum()
    timers, extra = [], []

    # K1: h bit-for-bit up to 1e-6 · max w (same cosf, no FMA contraction in
    # the products); the three sums to rtol 1e-5 (the kernel's block-tree
    # order against torch.sum's)
    err = 0.0
    for t in (1.0, 37.5, 2.0e4):  # the last one puts ω·t/2 up to 1e4
        for outcome in (0, 1):
            got = prec.fused_precession_update(omega, w, t, outcome,
                                               normalize=False)
            want = prec.fused_precession_update_plain(omega, w, t, outcome,
                                                      normalize=False)
            e = float((got[0] - want[0]).abs().max())
            require(e <= 1e-6 * float(w.max()),
                    f"K1 h differs by {e} at t={t}, outcome={outcome}")
            for name, a, b in zip(("norm", "ess", "mean"), got[1:], want[1:]):
                rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                require(rel <= 1e-5, f"K1 {name} rel err {rel} at t={t}, "
                                     f"outcome={outcome}")
            err = max(err, e)
    timers.append((
        dict(name="fused_precession_update", route="cuda",
             source="qinfer_tpu_torch/csrc/precession.cu",
             replaces="qinfer_tpu/ops/precession.py:80", max_abs_err=err),
        lambda: prec.fused_precession_update(omega, w, 37.5, 1,
                                             normalize=False),
        lambda: prec.fused_precession_update_plain(omega, w, 37.5, 1,
                                                   normalize=False)))
    say("kernels", f"K1 fused_precession_update n={n}: max |dh|={err:.3g}")

    # K2: cos² in [0, 1], atol 1e-6; at n = 1 too (the true model inside
    # simulate_experiment) and with several experiments
    err = 0.0
    ts = torch.tensor([0.5, 37.5, 2.0e4], device=dev)
    for om, tt in ((omega, ts[:1]), (omega, ts), (omega[:1], ts[1:2])):
        got = prec.precession_pr0(om, tt)
        want = prec.precession_pr0_plain(om, tt)
        require(got.shape == want.shape, "K2 shape")
        e = float((got - want).abs().max())
        require(e <= 1e-6, f"K2 differs by {e} at n={om.shape[0]}, "
                           f"n_e={tt.shape[0]}")
        err = max(err, e)
    timers.append((
        dict(name="precession_pr0", route="cuda",
             source="qinfer_tpu_torch/csrc/precession.cu",
             replaces="qinfer_tpu/ops/precession.py:146", max_abs_err=err),
        lambda: prec.precession_pr0(omega[:1], ts[1:2]),
        lambda: prec.precession_pr0_plain(omega[:1], ts[1:2])))
    extra.append(("precession_pr0 n=2^22",
                  lambda: prec.precession_pr0(omega, ts[1:2]),
                  lambda: prec.precession_pr0_plain(omega, ts[1:2])))
    say("kernels", f"K2 precession_pr0 n={n} and n=1: max err={err:.3g}")

    # K3: bit-exact (int32 views equal), at d = 1, at d = 3 with a
    # non-multiple n, and on a block of every kind of f32 pattern
    def fill_case(nn, d, bits):
        ww = torch.rand((nn,), generator=g, device=dev) ** 8 + 1e-12
        ww = ww / ww.sum()
        m, s = counting_multiplicities_from_u(0.37, ww, nn)
        require(int(m.sum()) == nn, "K3 counts do not sum to n")
        if bits:
            raw = torch.randint(-2**31, 2**31, (nn, d), generator=g,
                                device=dev, dtype=torch.int64)
            x = raw.to(torch.int32).view(torch.float32)
        else:
            x = torch.randn((nn, d), generator=g, device=dev)
        return m, s, x

    cases = [fill_case(n, 1, False), fill_case(n - 3, 3, False),
             fill_case(65536 + 7, 2, True)]
    for m, s, x in cases:
        got = sr.streaming_resample_locations(m, s, x)
        want = sr.streaming_resample_locations_plain(m, s, x)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"K3 not bit-exact at n={x.shape[0]}, d={x.shape[1]}")
    m, s, x = cases[0]
    timers.append((
        dict(name="streaming_resample_locations", route="cuda",
             source="qinfer_tpu_torch/csrc/streaming_resample.cu",
             replaces="qinfer_tpu/ops/streaming_resample.py:181",
             max_abs_err=0.0),
        lambda: sr.streaming_resample_locations(m, s, x),
        lambda: sr.streaming_resample_locations_plain(m, s, x)))
    say("kernels", f"K3 streaming_resample_locations n={n}, d=1: bit-exact "
                   f"(also d=3, n={n - 3}, and raw bit patterns)")
    return timers, extra


def time_kernels(timers, extra):
    """Phase 6: device time of each kernel and of its plain version at the
    main path's shapes, then at the shapes in ``extra`` (printed only)."""
    results = []
    for result, kernel_fn, plain_fn in timers:
        result["ms"], result["plain_ms"] = time_pair(kernel_fn, plain_fn)
        say("timing", f"{result['name']}: {result['ms']:.4f} ms device time "
                      f"(plain {result['plain_ms']:.4f} ms)")
        results.append(result)
    for label, kernel_fn, plain_fn in extra:
        ms, plain_ms = time_pair(kernel_fn, plain_fn)
        say("timing", f"{label}: {ms:.4f} ms device time "
                      f"(plain {plain_ms:.4f} ms)")
    return results


def check_engine(torch, dev):
    """Phase 4: the engine on the card against the plain path on the CPU on
    the same ensemble and outcomes, and perf_test at 4096 particles."""
    import numpy as np
    import qinfer_tpu_torch as qt
    from qinfer_tpu_torch.convert import state_from_numpy, state_to_numpy
    from qinfer_tpu_torch.smc import _update_step

    rng = np.random.default_rng(7)
    n = 4096
    arrays = dict(
        weights=np.full(n, 1.0 / n, np.float32),
        locations=rng.random((n, 1), dtype=np.float32),
        resample_count=0, just_resampled=False, log_total_likelihood=0.0,
        min_n_ess=float(n), zero_weight_count=0, resampler_fallback_count=0)
    model = qt.AcceleratedPrecessionModel()
    rs = qt.LiuWestResampler()
    states = {d: state_from_numpy(arrays, d) for d in ("cpu", dev)}
    gens = {d: torch.Generator(device=d) for d in states}
    for k in range(20):
        t = float(1.3 ** k)
        outcome = int(rng.integers(0, 2))
        for d in states:
            states[d], _, _ = _update_step(
                model, rs, states[d],
                torch.full((1,), outcome, dtype=torch.int32, device=d),
                {"t": torch.full((1,), t, device=d)}, 0.5, 1e-10, gens[d],
                check_resample=False)
    a, b = state_to_numpy(states[dev]), state_to_numpy(states["cpu"])
    err = float(np.abs(a["weights"] - b["weights"]).max())
    require(err <= 1e-5 * float(b["weights"].max()),
            f"engine weights on the card differ from the CPU by {err}")
    rel = abs(float(a["log_total_likelihood"] - b["log_total_likelihood"]))
    require(rel <= 1e-4 * max(1.0, abs(float(b["log_total_likelihood"]))),
            "engine evidence differs from the CPU")
    say("engine", f"20 reweight steps at n={n}: card vs CPU max |dw|="
                  f"{err:.3g}, log evidence {float(a['log_total_likelihood'])}"
                  f" vs {float(b['log_total_likelihood'])}")
    for seed in range(3):
        _, extra = qt.perf_test(qt.AcceleratedPrecessionModel(), n,
                                qt.UniformDistribution([[0.0, 1.0]]), 100,
                                true_mps=[[0.7]], seed=seed, device=dev)
        est = float(extra["est"][-1, 0])
        require(abs(est - 0.7) < 0.05, f"perf_test seed {seed}: est {est}")
    say("engine", f"perf_test n={n}, 100 steps, 3 seeds: |est - 0.7| < 0.05")


def run_main_path(torch, dev):
    """Phase 5: the benchmark protocol through the kernels, counted."""
    from qinfer_tpu_torch import bench
    from qinfer_tpu_torch.ops import precession as prec
    from qinfer_tpu_torch.ops import streaming_resample as sr

    counted = {"fused_precession_update": prec.fused_precession_update,
               "precession_pr0": prec.precession_pr0,
               "streaming_resample_locations":
                   sr.streaming_resample_locations}
    bench.timed_run(N_MAIN, bench.N_STEPS, 0, dev)  # warm-up
    walls, launches = [], {}
    for rep in range(bench.N_REPEATS):
        for fn in counted.values():
            fn.launches = 0
        wall, updater = bench.timed_run(N_MAIN, bench.N_STEPS, rep + 1, dev)
        launches = {name: fn.launches for name, fn in counted.items()}
        walls.append(wall)
        st = updater.state
        est = float(updater.est_mean()[0])
        require(abs(est - 0.7) < 0.05, f"main path est {est} != 0.7")
        require(bool(torch.isfinite(st.weights).all())
                and bool(torch.isfinite(st.locations).all())
                and math.isfinite(updater.log_total_likelihood),
                "NaN or inf in the state after the main path")
        require(launches["fused_precession_update"] == bench.N_STEPS,
                f"K1 launched {launches['fused_precession_update']} times")
        require(launches["precession_pr0"] == bench.N_STEPS,
                f"K2 launched {launches['precession_pr0']} times")
        require(launches["streaming_resample_locations"]
                == updater.resample_count > 0,
                f"K3 launched {launches['streaming_resample_locations']} "
                f"times for {updater.resample_count} resamples")
        say("main", f"run {rep}: {wall:.4f} s, est {est:.6f}, "
                    f"{updater.resample_count} resamples, launches {launches}")
    best = min(walls)
    rate = N_MAIN * bench.N_STEPS / best
    return launches, best, rate


def main():
    sys.path.insert(0, ROOT)
    try:
        import torch
    except ImportError as exc:
        raise SmokeFailure(f"torch is not installed: {exc}")
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    try:
        from qinfer_tpu_torch import kernels
        from qinfer_tpu_torch.bench import card_label
    except ImportError as exc:
        raise SmokeFailure(f"the port is not next to chip_smoke.py: {exc}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_label()
    require(not card.startswith("nvidia-smi"), card)
    print(card, flush=True)
    say("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(dev)}, nvcc "
               f"{kernels.find_nvcc()}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path, log = kernels.build()
    kernels.library()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say("build", f"{os.path.relpath(lib_path, ROOT)} in "
                 f"{time.perf_counter() - t0:.1f} s; ptxas: {regs}")

    timers, extra = check_kernels(torch, dev)
    check_engine(torch, dev)
    launches, best, rate = run_main_path(torch, dev)
    say("main", f"best of 3 runs: {best:.4f} s for "
                f"{N_MAIN} particles x 256 steps = {rate:.6g} "
                f"particle-updates/s on {card}")
    results = time_kernels(timers, extra)
    require("jax" not in sys.modules, "JAX was imported")

    for r in results:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
