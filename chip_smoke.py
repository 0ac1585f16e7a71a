#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port starts on a GPU.

Run from the root of a checkout with ``python3 chip_smoke.py`` on a
machine with one NVIDIA Hopper card. It drives the port
(``qinfer_tpu_torch``), never the JAX package, in phases; each phase prints
one line, and any failure exits non-zero without the final ``ok`` line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, nvcc;
2. build: compiles the hand-written kernels from ``qinfer_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (K1-K3 at 2²² particles, K2 also at n = 1, the
   shape the loop gives it, K3 also at the process path's n = 50 000,
   d = 255, bit-exact on raw bit patterns; the Jacobi kernels K4-K6, equal
   to their plain versions to the bit, on embedded Ginibre/BCSZ states
   pushed out of the PSD cone as Liu-West proposals are, and on random
   symmetric matrices, also against host float64 ``numpy.linalg.eigh`` on
   a subsample), with the tolerance stated;
4. engine: 20 reweight steps on the card against the same steps run by the
   plain path on the CPU, the device kernels of one engine reweight (K1
   alone), and ``perf_test`` at 4096 particles;
5. main paths, each with every kernel launch counter reset to 0 before and
   read after each run: the precession benchmark protocol (2²²
   particles, 256 adaptive steps, ESS check every step, Liu-West
   resampling); two-qubit process tomography (255 parameters, 50 000
   particles, 1000 steps: K5 at every strict projection, K3 at every
   resample, K6 in the BCSZ prior draw); diffusive two-qubit state
   tomography (100 000 particles, 200 steps: K4 at every step that left
   the cone); the resample-move process path (the same 50 000 x 1000 at
   64 shots an experiment, 8 adaptive Metropolis sweeps after each
   resample: K3, K5 and K6 as on the process path, one move call a
   resample, mean acceptance near its target 0.14, and each run's
   fidelity above the single-shot process run's on its seed); the EIG
   flagship path (the resample-move path with ``--eig --eig-policy
   egreedy --eig-interval 4`` at 2000 steps: each experiment picked from
   the 256-pair pool by its expected information gain, the pool rescored
   every 4th step and after each resample; K3, K5 and K6 as on the
   resample-move path, and the rescore count of the JAX benchmark's rule
   on the run's own resample steps). Each tomography run must beat the
   prior mean's fidelity.
   Then BASELINE config 5 (``expdesign_bench``: 10⁷ particles, 32 steps,
   16 candidates scored by information gain, unchunked and 4 at a time):
   the posterior mean within 0.05 of 0.7, K3 once per resample and bit-
   exact on one of the run's resamples, chunked and unchunked scores
   equal on the final state, and the peak memory of a chunked scoring
   call (64 at a time) the same at 256 and at 1024 candidates.
   Then the models path: BASELINE configs 2 (Ramsey with T2, d = 2) and
   3 (randomized benchmarking, d = 3) through ``models_bench`` at 50 000
   particles and ``--repeats 8`` (``SMCUpdater.batch_update`` over 256
   and 128 experiments, the ESS checked every 5th step): K3 once per
   resample of each timed run and bit-exact on one of each config's own
   resamples, each posterior mean within 4 sd of the truth, config 3's
   credible set, hull vertices and MVEE finite, and whether the truth lies
   in its ``hpd_mvee`` region; then ``simple_est_rb`` at its defaults on a
   synthetic record (K3 once per resample).
   Then the item-8 phase (``item8_bench``): drift tracking under a fixed
   and a learned random walk (50 000 particles x 1000 steps, K3 at d = 1
   and 2), the multinomial die (50 000 x 200 experiments of 100 rolls, K3
   at d = 6; the ESS checked every step, and every 5th step for
   context), ALE (50 000 x 200 single shots, adaptive rounds a step),
   referenced-Poisson readout (50 000 x 300, K3 at d = 3) with one
   ``MLEModel`` and one ``PoisonedModel`` step, and GADFLI-prior
   two-qubit state tomography (100 000 x 200: K3 at d = 15, K4 once per
   gated projection) with a Ginibre-prior run beside it; each run's
   launches counted, its state finite, its checks held (4 sd, the die's
   ``max_z_vs_true``, fresh ALE noise, fidelity above the prior mean's)
   and K3 bit-exact on its first resample; K3's times at the new d go
   under its ``other_shapes``, K4's launches on the GADFLI run under
   ``launches_item8_gadfli``.
   Then the trials phase (``perf_test_scan_batch`` at the JAX trials
   benchmark's width, 32 trials x 131 072 particles x 256 steps,
   ``SimplePrecessionModel`` + PGH): batched at ESS intervals 0 and 8
   (one K3 launch a step over the rows of every trial that resamples) and
   sequential on a one-card mesh at interval 0 (one K3 launch a
   resample); each run's median |estimate − truth| below 0.05 and median
   last/first loss ratio below 1e-2, its aggregate updates/s printed; one
   recorded batched K3 call replayed against the plain twin and each
   trial's own K3 fill, to the bit; one batched run of 4 x 131 072 x 64
   with ``AcceleratedPrecessionModel`` (K1 and K2 once a trial and step;
   K1 held against its plain version on each trial's last-step inputs).
   Then the resume phase: the resample-move recipe at 50 000 particles x
   255 parameters through ``SMCUpdater``, 200 steps, ``save_updater``,
   ``load_updater`` into an updater of another seed, and 200 more steps of
   both on the same experiments and outcomes, equal to the bit after
   every step (K3, K5 and K6 counted).
   Then one more precession run records the largest |ω·t/2| that K1
   meets, and K1 is checked on that step's particles and t;
6. timing: each kernel's time against its plain version's and, where one
   PyTorch call computes the same function, that call's (``library_ms``:
   ``repeat_interleave`` for K3, ``torch.linalg.eigh`` for K6 where
   cuSOLVER takes the batch), beside the kernel's bound (:func:`bound`),
   after the main paths so the profiler cannot slow the loops: K1-K3 by
   profiler device time (by CUDA events around calls queued behind a
   spin where the profiler sees none; each line and result's ``timer``
   says which), K4-K6 by CUDA events; beside them shapes and designs
   timed for comparison (K4's input through K5's one matrix a warp, K1
   at the path's late-step t). K3 at the models, item-8 and trials
   paths' shapes goes into K3's entry of the kernels line, under
   ``other_shapes``, and K1 at the accelerated trials run's shape (n =
   131 072) into K1's; K1's launches on that run also go under
   ``launches_trials_accelerated``, and each kernel's launches on the
   resume phase under ``launches_resume``.

Then it prints the kernels' JSON line, the card line and, last,
``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --kernels-only``
runs phases 1-3 and 6 alone, prints the kernels' line (without launch
counts) and the card, and no ``ok`` line.
"""

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 1 << 22
#: the tomography paths: (mode, particles, steps)
TOMO_PATHS = (("process", 50_000, 1000), ("diffusive", 100_000, 200))
#: the resample-move path: ``tomography_bench``'s flags, and its size
MOVES_PATH = ("--process --process-qubits 2 --shots 64 --moves 8 --adapt "
              "--target-accept 0.14 --interval 4 --no-move-canonicalize")
MOVES_PATH_SIZE = (50_000, 1000)
#: the EIG flagship path: the resample-move path with experiment design,
#: at twice its steps. Up to 4000 steps the amortized design trails the
#: uniform pick (in the JAX package too: its CPU run at 20 000 x 1000,
#: 0.5279 against 0.6284), and at 1000 steps its fidelity clears the
#: prior mean's by as little as 0.02; at 2000 it reads 0.59-0.66
EIG_PATH = MOVES_PATH + " --eig --eig-policy egreedy --eig-interval 4"
EIG_PATH_SIZE = (50_000, 2000)
#: BASELINE config 5: (particles, steps, candidates), the chunk of its
#: second run, and the chunked scoring call's chunk and pool sizes
CONFIG5 = (10_000_000, 32, 16)
CONFIG5_CHUNK = 4
CONFIG5_MEMORY = (64, (256, 1024))
#: the models path (BASELINE configs 2 and 3): particles, ladder repeats
MODELS = (50_000, 8)
#: the trials phase: the JAX trials benchmark's configuration (trials,
#: particles, steps) and seed, the batched runs' ESS intervals, and the
#: accelerated batched run (trials, particles, steps)
TRIALS = (32, 131_072, 256)
TRIALS_SEED = 11
TRIALS_INTERVALS = (0, 8)
TRIALS_K1 = (4, 131_072, 64)
#: the resume phase: particles, steps before the checkpoint and after it
RESUME = (50_000, 200, 200)
#: rows of each Jacobi batch held against host float64
N_F64 = 2000
#: the process path's resample fill: (particles, parameters)
K3_PROCESS = (50_000, 255)
#: the card's peaks (H100 SXM data sheet): device-memory bytes a second,
#: and float32 operations a second outside the tensor cores with each
#: operation rounded on its own (the sheet's 67 TFLOP/s count an FMA as 2)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12


def bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the least time of a call that must move
    ``nbytes`` of device memory (each input read once, each output written
    once) and do ``ops`` float32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def jacobi_bound(n, d, sweeps, project):
    """Bound of a Jacobi kernel call on ``n`` (d, d) matrices: per rotation
    15 operations for the angle and 18·d for the columns of A and V and the
    rows of A (4 products and 2 sums a pair of entries); the projection's
    epilogue 4·d for the clipped trace and 3·d − 1 per upper-triangle
    entry. Divides and square roots count as one operation each. Bytes:
    the batch read once and written once (and d eigenvalues for K6)."""
    ops = sweeps * (d - 1) * (d // 2) * (18 * d + 15)
    if project:
        ops += 4 * d + d * (d + 1) // 2 * (3 * d - 1)
    nbytes = 8 * d * d + (0 if project else 4 * d)
    return bound(n * nbytes, n * ops)


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_events(fn, reps, tries=3):
    """The profiler's device events (kernels and copies, averaged by name)
    of ``reps`` calls of ``fn()`` after a warm-up call. On the card the
    profiler now and then reports no device event for a session; such a
    session is run again, up to ``tries`` times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        if events:
            return events
    raise SmokeFailure(f"the profiler saw no device time in {tries} tries")


def device_ms(fn, reps=20):
    """Time of one ``fn()`` in ms, and how it was taken. First by the
    profiler: every kernel and copy it runs, summed over ``reps`` calls
    ("device time"); the host's launch overhead is left out, and inputs
    that fit the 50 MB L2 stay warm across calls. Late in this script's
    long process the profiler has once reported no device event in any of
    its tries; the time is then taken by :func:`queued_ms`."""
    try:
        us = sum(e.self_device_time_total for e in device_events(fn, reps))
    except SmokeFailure:
        us = 0
    if us > 0:
        return us / 1e3 / reps, "device time"
    return queued_ms(fn, reps)


def queued_ms(fn, reps=20, clock_hz=2.0e9):
    """Time of one ``fn()`` in ms by CUDA events around ``reps`` calls that
    the host queued while the card spun (``torch.cuda._sleep`` for twice
    the host's time to queue them, in cycles at ``clock_hz``, above the
    card's clock), so that the calls run back to back and the events
    bracket device time, not the host's launch rate. If the first event
    had already fired when the host finished queuing, the spin is doubled
    and the reading taken again; after four tries (a ``fn`` that waits
    for the card) the events time the calls as the host paces them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin = 2 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * clock_hz))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return (start.elapsed_time(end) / reps,
                    "CUDA events behind a spin (the profiler saw no device "
                    "time)")
        spin *= 2
    return (event_ms(fn, reps),
            "CUDA events, paced by the host (the profiler saw no device "
            "time)")


def event_ms(fn, reps=5):
    """Time of one ``fn()`` in ms between two CUDA events around ``reps``
    back-to-back calls. For the Jacobi kernels and their plain versions:
    the plain ones launch ~10⁴ kernels a call, and after some 30 such
    profiler sessions in one process the profiler stopped reporting
    device time (two calls on the card). A kernel's single launch or the
    plain version's long device queue keeps the card busy between the
    events, so this is device time up to the first launch's latency."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(fns, timer):
    """Times of each of ``fns`` (kernel first), taken in turns: the list,
    then the list reversed (plain, library, kernel, kernel, library,
    plain); each the mean of its two readings, with how they were taken
    (``timer`` returns ``(ms, how)``)."""
    first = [timer(fn) for fn in reversed(fns)][::-1]
    second = [timer(fn) for fn in fns]
    return [((a + b) / 2, ha if ha == hb else f"{ha}, then {hb}")
            for (a, ha), (b, hb) in zip(first, second)]


def timed(result, kernel, plain, library=None, no_library=None,
          bound_at=None, attach=None):
    """One kernel to time: its JSON ``result`` (or a label for a shape
    timed besides), its kernel, plain and library calls, why it has no
    library call, and ``(bound_ms, bound_by)`` at this shape. A shape timed
    besides with ``attach``, a dict naming its ``kernel``, goes into that
    kernel's result under ``other_shapes``, with the dict's other keys."""
    return dict(result=result, kernel=kernel, plain=plain, library=library,
                no_library=no_library, bound=bound_at, attach=attach)


def hold_k1(omega, w, t, outcome, where):
    """K1 against its plain version on one call's inputs: h to 1e-6 · max w
    (the same cosf, no FMA contraction in the products), the three sums to
    rtol 1e-5 (the kernel's block-tree order against torch.sum's). Returns
    max |dh|."""
    from qinfer_tpu_torch.ops import precession as prec

    got = prec.fused_precession_update(omega, w, t, outcome, normalize=False)
    want = prec.fused_precession_update_plain(omega, w, t, outcome,
                                              normalize=False)
    e = float((got[0] - want[0]).abs().max())
    require(e <= 1e-6 * float(w.max()), f"K1 h differs by {e} {where}")
    for name, a, b in zip(("norm", "ess", "mean"), got[1:], want[1:]):
        rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
        require(rel <= 1e-5, f"K1 {name} rel err {rel} {where}")
    return e


def check_kernels(torch, dev):
    """Phase 3: each kernel against its plain version at main-path shapes.

    Returns one :func:`timed` entry per kernel, at the shape the main path
    launches it with (K2 at n = 1: the true model inside
    ``simulate_experiment``; K3 at the precession path's d = 1), and
    entries for shapes timed besides (K2 at n = 2²², K3 at the process
    path's d = 255). The timing itself runs after the main path
    (:func:`time_kernels`), so that the profiler cannot slow the timed
    loop."""
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

    # K1 (:func:`hold_k1`)
    err = 0.0
    for t in (1.0, 37.5, 2.0e4):  # the last one puts ω·t/2 up to 1e4
        for outcome in (0, 1):
            err = max(err, hold_k1(omega, w, t, outcome,
                                   f"at t={t}, outcome={outcome}"))
    # t and the outcome on the card (the engine's form, int32 and int64)
    # give the by-value results to the bit, twice over
    ref = prec.fused_precession_update(omega, w, 37.5, 1, normalize=False)
    for odt in (torch.int32, torch.int64):
        for _ in range(2):
            got = prec.fused_precession_update(
                omega, w, torch.full((1,), 37.5, device=dev),
                torch.ones((1,), dtype=odt, device=dev), normalize=False)
            require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                    f"K1 with t and a {odt} outcome on the card is not "
                    "bit-identical to the by-value call")
    # bound: ω and w read, h written; ~10 operations a particle (cosf as 1)
    timers.append(timed(
        dict(name="fused_precession_update", route="cuda",
             source="qinfer_tpu_torch/csrc/precession.cu",
             replaces="qinfer_tpu/ops/precession.py:80", max_abs_err=err),
        lambda: prec.fused_precession_update(omega, w, 37.5, 1,
                                             normalize=False),
        lambda: prec.fused_precession_update_plain(omega, w, 37.5, 1,
                                                   normalize=False),
        no_library="no one PyTorch call fuses the reweight and its sums",
        bound_at=bound(12 * n, 10 * n)))
    say("kernels", f"K1 fused_precession_update n={n}: max |dh|={err:.3g}; "
                   "deterministic, t and int32/int64 outcome on the card")

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
    # bound: ω and t read, cos² written; 3 operations an entry (cosf as 1)
    no_cos2 = "no one PyTorch call computes cos²(ω·t/2)"
    timers.append(timed(
        dict(name="precession_pr0", route="cuda",
             source="qinfer_tpu_torch/csrc/precession.cu",
             replaces="qinfer_tpu/ops/precession.py:146", max_abs_err=err),
        lambda: prec.precession_pr0(omega[:1], ts[1:2]),
        lambda: prec.precession_pr0_plain(omega[:1], ts[1:2]),
        no_library=no_cos2, bound_at=bound(12, 3)))
    extra.append(timed(
        "precession_pr0 n=2^22",
        lambda: prec.precession_pr0(omega, ts[1:2]),
        lambda: prec.precession_pr0_plain(omega, ts[1:2]),
        no_library=no_cos2, bound_at=bound(8 * n + 4, 3 * n)))
    say("kernels", f"K2 precession_pr0 n={n} and n=1: max err={err:.3g}")

    # K3: bit-exact (int32 views equal), at d = 1, at d = 3 with a
    # non-multiple n, and on blocks of every kind of f32 pattern, one of
    # them at the process path's shape
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
             fill_case(65536 + 7, 2, True), fill_case(*K3_PROCESS, True)]
    for m, s, x in cases:
        got = sr.streaming_resample_locations(m, s, x)
        want = sr.streaming_resample_locations_plain(m, s, x)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"K3 not bit-exact at n={x.shape[0]}, d={x.shape[1]}")

    def fill_timed(result, m, s, x):
        # bound: starts and x read, out written; no arithmetic
        nn, d = x.shape
        return timed(
            result, lambda: sr.streaming_resample_locations(m, s, x),
            lambda: sr.streaming_resample_locations_plain(m, s, x),
            library=lambda: torch.repeat_interleave(x, m, dim=0,
                                                    output_size=nn),
            bound_at=bound(4 * nn + 8 * nn * d, 0))

    timers.append(fill_timed(
        dict(name="streaming_resample_locations", route="cuda",
             source="qinfer_tpu_torch/csrc/streaming_resample.cu",
             replaces="qinfer_tpu/ops/streaming_resample.py:181",
             max_abs_err=0.0), *cases[0]))
    extra.append(fill_timed("streaming_resample_locations n=%d, d=%d"
                            % K3_PROCESS, *cases[3]))
    say("kernels", f"K3 streaming_resample_locations n={n}, d=1: bit-exact "
                   f"(also d=3, n={n - 3}, and raw bit patterns at d=2 and "
                   f"at n, d = {K3_PROCESS})")
    return timers, extra


def _pushed_states(torch, dev, prior, model, n, g):
    """Embedded states of ``n`` prior particles after one Liu-West-style
    move (a = 0.98 shrinkage towards the mean plus h·L·z with the
    ensemble's covariance): the inputs a strict projection meets."""
    x = prior.sample(g, n)
    mu = x.mean(0)
    xc = x - mu
    cov = xc.T @ xc / n + 1e-10 * torch.eye(x.shape[1], device=dev)
    L = torch.linalg.cholesky(cov)
    z = torch.randn(x.shape, generator=g, device=dev)
    h = math.sqrt(1.0 - 0.98 ** 2)
    return model._embedded_states(0.98 * x + 0.02 * mu + h * z @ L.T)


def _random_symmetric(torch, dev, n, d, g):
    """(B + Bᵀ)/2 with B standard normal: the inputs the JAX package's own
    TPU accuracy figures were measured on."""
    b = torch.randn((n, d, d), generator=g, device=dev)
    return ((b + b.transpose(1, 2)) / 2).contiguous()


def _f64_projection(np, a):
    """Host float64 projection of ``a`` (n, d, d) to trace 2, and the rows
    with positive mass (a clipped trace above 1e-3)."""
    ev, V = np.linalg.eigh(a.astype(np.float64))
    ev = np.clip(ev, 0.0, None)
    mass = ev.sum(-1)
    ev = 2.0 * ev / np.clip(mass[:, None], 1e-35, None)
    return np.einsum("nab,nb,ncb->nac", V, ev, V), mass > 1e-3


def check_jacobi_kernels(torch, dev):
    """Phase 3, K4-K6: each kernel against its plain version on the card at
    the main paths' shapes, and against host float64 on ``N_F64`` rows.

    Inputs: embedded states pushed out of the cone (2-qubit Ginibre at
    d = 8, 3-qubit Ginibre at d = 16, 2-qubit BCSZ Choi states at d = 32;
    ``EMBEDDED_SWEEPS`` sweeps, as the models run them) and random
    symmetric matrices (6 sweeps, the kernels' default).

    Tolerances. Kernel against plain: 0 (``torch.equal``, eigenvalues and
    eigenvectors for K6); the kernel rounds each step as the plain
    version's separate ops do. Against float64: the JAX package's TPU accuracy figures
    (docs/PERF_NOTES.md): projection 2.3e-6 at d = 8, 2.5e-5 at d = 16,
    2.8e-5 at d = 32; eigenvalues 1.1e-5 at d = 8 and 2.5e-5 at d = 16.
    Also: exact symmetry, trace 2 ± 1e-4 on rows with positive mass, and
    for K6 reconstruction ≤ 2e-5·max|a| and ‖VᵀV − I‖∞ ≤ 1e-5."""
    import numpy as np
    from qinfer_tpu_torch import tomography as tomo
    from qinfer_tpu_torch.ops import jacobi as jac
    from qinfer_tpu_torch.tomography.bases import (
        EMBEDDED_SWEEPS, batched_jacobi_eigh_small)

    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    inputs = {}
    for d, nq, n, prior_of in ((8, 2, 100_000, tomo.GinibreDistribution),
                               (16, 3, 50_000, tomo.GinibreDistribution),
                               (32, 4, 50_000, tomo.BCSZChoiDistribution)):
        basis = tomo.pauli_basis(nq)
        states = _pushed_states(torch, dev, prior_of(basis),
                                tomo.TomographyModel(basis), n, g)
        inputs[d] = ((states, EMBEDDED_SWEEPS),
                     (_random_symmetric(torch, dev, n, d, g), 6))

    timers, extra = [], []
    no_projection = "no one PyTorch call projects onto the PSD cone"
    proj_tol = {8: 2.3e-6, 16: 2.5e-5, 32: 2.8e-5}
    # (kernel, its plain version, TPU wrapper line, shapes checked, the
    # main path's shape: the diffusive path's d = 8, the process path's 32)
    for name, fn, plain, line, dims, main_d in (
            ("jacobi_project_lanes", jac.jacobi_project_lanes,
             jac.jacobi_project_lanes_plain, 309, (8, 16), 8),
            ("jacobi_project_lanes_looped", jac.jacobi_project_lanes_looped,
             jac.jacobi_project_lanes_looped_plain, 230, (32,), 32)):
        err = 0.0
        for d in dims:
            for a, sweeps in inputs[d]:
                got = fn(a, sweeps=sweeps)
                want = plain(a, sweeps=sweeps)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                require(torch.equal(got, want),
                        f"{name} d={d} differs from plain by {e}")
                require(torch.equal(got, got.transpose(1, 2)),
                        f"{name} d={d}: output not exactly symmetric")
                sub = got[:N_F64].cpu().numpy()
                ref, mass = _f64_projection(np, a[:N_F64].cpu().numpy())
                tr = np.trace(sub, axis1=1, axis2=2)[mass]
                require(float(np.abs(tr - 2.0).max()) <= 1e-4,
                        f"{name} d={d}: trace off 2")
                e64 = float(np.abs(sub - ref).max())
                require(e64 <= proj_tol[d], f"{name} d={d} sweeps={sweeps}:"
                        f" {e64} from float64 (tolerance {proj_tol[d]})")
                say("kernels", f"{name} {tuple(a.shape)} sweeps={sweeps}: "
                               f"|kernel - plain| {e:.3g}, |kernel - f64| "
                               f"{e64:.3g}")
                err = max(err, e)
        a, sweeps = inputs[main_d][0]
        timers.append(timed(
            dict(name=name, route="cuda",
                 source="qinfer_tpu_torch/csrc/jacobi.cu",
                 replaces=f"qinfer_tpu/ops/jacobi.py:{line}",
                 max_abs_err=err),
            lambda fn=fn, a=a, s=sweeps: fn(a, sweeps=s),
            lambda plain=plain, a=a, s=sweeps: plain(a, sweeps=s),
            no_library=no_projection,
            bound_at=jacobi_bound(a.shape[0], main_d, sweeps, True)))
    a16, s16 = inputs[16][0]
    extra.append(timed(
        "jacobi_project_lanes (50000, 16, 16)",
        lambda: jac.jacobi_project_lanes(a16, sweeps=s16),
        lambda: jac.jacobi_project_lanes_plain(a16, sweeps=s16),
        no_library=no_projection,
        bound_at=jacobi_bound(a16.shape[0], 16, s16, True)))
    # K4's main-path input with one matrix a warp (K5's entry): the design
    # that packing replaced
    a, sweeps = inputs[8][0]
    extra.append(timed(
        "jacobi_project_lanes_looped (100000, 8, 8), one matrix a warp",
        lambda a=a, s=sweeps: jac.jacobi_project_lanes_looped(a, sweeps=s),
        lambda a=a, s=sweeps: jac.jacobi_project_lanes_plain(a, sweeps=s),
        no_library=no_projection,
        bound_at=jacobi_bound(a.shape[0], 8, sweeps, True)))

    ev_tol = {8: 1.1e-5, 16: 2.5e-5}
    err = 0.0
    for d in (8, 16):
        for a, sweeps in inputs[d]:
            before = jac.jacobi_eigh_lanes.launches
            ev, V = batched_jacobi_eigh_small(a, sweeps=sweeps)
            ev_p, V_p = jac.jacobi_eigh_lanes_plain(a, sweeps=sweeps)
            torch.cuda.synchronize()
            require(jac.jacobi_eigh_lanes.launches == before + 1,
                    "batched_jacobi_eigh_small did not launch K6")
            e = float((ev - ev_p).abs().max())
            require(torch.equal(ev, ev_p), f"K6 d={d} eigenvalues differ "
                                           f"from plain by {e}")
            ev_err = float((V - V_p).abs().max())
            require(torch.equal(V, V_p), f"K6 d={d} eigenvectors differ "
                                         f"from plain by {ev_err}")
            scale = float(a.abs().max())
            recon = float(((V * ev[:, None, :]) @ V.transpose(1, 2) - a)
                          .abs().max())
            require(recon <= 2e-5 * scale, f"K6 d={d}: reconstruction off "
                                           f"by {recon}")
            eye = torch.eye(d, device=dev)
            orth = float((V.transpose(1, 2) @ V - eye).abs().max())
            require(orth <= 1e-5, f"K6 d={d}: |VᵀV - I| = {orth}")
            want = np.linalg.eigvalsh(a[:N_F64].cpu().double().numpy())
            e64 = float(np.abs(np.sort(ev[:N_F64].cpu().numpy(), -1)
                               - want).max())
            require(e64 <= ev_tol[d], f"K6 d={d} sweeps={sweeps}: "
                    f"eigenvalues {e64} from float64 (tolerance "
                    f"{ev_tol[d]})")
            say("kernels", f"jacobi_eigh_lanes {tuple(a.shape)} sweeps="
                           f"{sweeps}: |kernel - plain| {e:.3g}, "
                           f"reconstruction {recon:.3g}, |VᵀV - I| "
                           f"{orth:.3g}, |ev - f64| {e64:.3g}")
            err = max(err, e)
    # K6's main-path shape: E(S) of the BCSZ prior draw, (50 000, 8, 8)
    a8 = inputs[8][0][0][:50_000].contiguous()
    timers.append(timed(
        dict(name="jacobi_eigh_lanes", route="cuda",
             source="qinfer_tpu_torch/csrc/jacobi.cu",
             replaces="qinfer_tpu/ops/jacobi.py:269", max_abs_err=err),
        lambda: jac.jacobi_eigh_lanes(a8, sweeps=EMBEDDED_SWEEPS),
        lambda: jac.jacobi_eigh_lanes_plain(a8, sweeps=EMBEDDED_SWEEPS),
        **eigh_library(torch, a8),
        bound_at=jacobi_bound(a8.shape[0], 8, EMBEDDED_SWEEPS, False)))
    extra.append(timed(
        "jacobi_eigh_lanes (50000, 16, 16)",
        lambda: jac.jacobi_eigh_lanes(a16, sweeps=s16),
        lambda: jac.jacobi_eigh_lanes_plain(a16, sweeps=s16),
        no_library="not timed at this shape",
        bound_at=jacobi_bound(a16.shape[0], 16, s16, False)))
    return timers, extra


def eigh_library(torch, a):
    """K6's library call, ``torch.linalg.eigh`` on the same batch, if
    cuSOLVER takes it; else the refusal, and the time of the largest batch
    (halving from ``a``'s) that it takes."""
    def call(b):
        return lambda: torch.linalg.eigh(b)

    try:
        call(a)()
        torch.cuda.synchronize()
        return dict(library=call(a))
    except RuntimeError as exc:
        refusal = str(exc).strip().splitlines()[0]
    b = a[:a.shape[0] // 2]
    while b.shape[0] >= 1:
        try:
            call(b)()
            torch.cuda.synchronize()
        except RuntimeError:
            b = b[:b.shape[0] // 2]
            continue
        say("kernels", f"torch.linalg.eigh takes {b.shape[0]} of the "
                       f"{a.shape[0]} (8, 8) matrices: {event_ms(call(b)):.4f}"
                       f" ms by CUDA events")
        break
    return dict(no_library=f"torch.linalg.eigh refuses the batch "
                           f"{tuple(a.shape)}: {refusal}")


def time_kernels(timers, extra):
    """Phase 6: time of each kernel, of its plain version and of its
    library call at the main paths' shapes, then at the shapes in
    ``extra`` (printed only): K1-K3 by profiler device time, first
    (:func:`device_ms`, with its CUDA-event fallback); then the Jacobi
    kernels K4-K6 by CUDA events (:func:`event_ms`). Each result gains
    ``ms``, ``plain_ms``, ``library_ms`` (null, with the reason printed,
    where no one PyTorch call computes the same function), ``bound_ms``,
    ``bound_by`` and ``timer``, how the kernel's time was taken."""
    results, attached = [], []
    for jacobi in (False, True):
        timer = ((lambda fn: (event_ms(fn), "CUDA events")) if jacobi
                 else device_ms)
        for t in timers + extra:
            label = t["result"]
            label = label if isinstance(label, str) else label["name"]
            if label.startswith("jacobi") != jacobi:
                continue
            fns = [t["kernel"], t["plain"]] + (
                [t["library"]] if t["library"] else [])
            turns = time_turns(fns, timer)
            ms = [m for m, _ in turns] + [None]
            hows = [h for _, h in turns]
            how = hows[0] if len(set(hows)) == 1 else " / ".join(
                f"{w}: {h}" for w, h in zip(("kernel", "plain", "library"),
                                            hows))
            bound_ms, bound_by = t["bound"]
            say("timing", f"{label}: {ms[0]:.4f} ms (plain {ms[1]:.4f} ms, "
                          "library " + (f"{ms[2]:.4f} ms" if ms[2] is not None
                                        else "none") +
                          f"; bound {bound_ms:.4g} ms by {bound_by}, "
                          f"{100 * bound_ms / ms[0]:.1f} % of it) by {how}")
            if ms[2] is None:
                say("timing", f"{label}: no library call: "
                              f"{t['no_library']}")
            numbers = dict(ms=ms[0], plain_ms=ms[1], library_ms=ms[2],
                           bound_ms=bound_ms, bound_by=bound_by,
                           timer=hows[0])
            if not isinstance(t["result"], str):
                t["result"].update(numbers)
                results.append(t["result"])
            elif t["attach"] is not None:
                attached.append(dict(t["attach"], shape=label, **numbers))
    for a in attached:
        r = next(r for r in results if r["name"] == a["kernel"])
        r.setdefault("other_shapes", []).append(
            {k: v for k, v in a.items() if k != "kernel"})
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
    kernels = reweight_kernels(torch, dev, model, states[dev])
    require(len(kernels) == 1, f"one engine reweight ran {len(kernels)} "
                               f"device kernels: {kernels}")
    say("engine", f"device kernels of one engine reweight: {len(kernels)} "
                  f"({kernels[0]})")
    for seed in range(3):
        _, extra = qt.perf_test(qt.AcceleratedPrecessionModel(), n,
                                qt.UniformDistribution([[0.0, 1.0]]), 100,
                                true_mps=[[0.7]], seed=seed, device=dev)
        est = float(extra["est"][-1, 0])
        require(abs(est - 0.7) < 0.05, f"perf_test seed {seed}: est {est}")
    say("engine", f"perf_test n={n}, 100 steps, 3 seeds: |est - 0.7| < 0.05")


def reweight_kernels(torch, dev, model, state):
    """Names of the device kernels (and copies) that the model's
    ``fused_reweight`` runs when the engine calls it (``smc._reweight``:
    the outcome and t on the card, int32 and float32), by the profiler,
    after a warm-up call."""
    outcome = torch.ones((1,), dtype=torch.int32, device=dev)
    eps = {"t": torch.full((1,), 37.5, device=dev)}

    def call():
        return model.fused_reweight(state.weights, state.locations, outcome,
                                    eps)

    return [e.key for e in device_events(call, 1) for _ in range(e.count)]


def late_step_k1(torch, dev):
    """One more precession run (the protocol of ``bench.timed_run``, seed
    1) that records, before each update, the largest |ω·t/2| K1 will meet.
    Checks K1 against its plain version on the particles and t of the step
    with the largest, and returns ``(its timing entry, max |ω·t/2|, t)``."""
    from qinfer_tpu_torch import bench
    from qinfer_tpu_torch.heuristics import PGH
    from qinfer_tpu_torch.ops import precession as prec

    updater = bench.make_updater(N_MAIN, 1, dev)
    pgh = PGH(updater)
    g = torch.Generator(device=dev)
    g.manual_seed(1001)
    true_omega = torch.full((1, 1), bench.TRUE_OMEGA, device=dev)
    worst = (-1.0, None, None, None)
    for idx in range(bench.N_STEPS):
        eps = pgh(idx)
        t = float(eps["t"][0])
        omega = updater.particle_locations[:, 0]
        arg = float(omega.abs().max()) * t / 2
        if arg > worst[0]:
            worst = (arg, t, omega.clone(), updater.particle_weights.clone())
        outcome = updater.model.simulate_experiment(g, true_omega, eps)
        updater.update(outcome, eps)
    arg, t, omega, w = worst
    e = hold_k1(omega, w, t, 1, f"at the path's late-step t={t}")
    n = omega.shape[0]
    entry = timed(
        f"fused_precession_update n=2^22 at the path's largest |ω·t/2| = "
        f"{arg:.6g} (t = {t:.6g})",
        lambda: prec.fused_precession_update(omega, w, t, 1, normalize=False),
        lambda: prec.fused_precession_update_plain(omega, w, t, 1,
                                                   normalize=False),
        no_library="no one PyTorch call fuses the reweight and its sums",
        bound_at=bound(12 * n, 10 * n))
    say("main", f"precession: largest |ω·t/2| = {arg:.6g} at t = {t:.6g}; "
                f"K1 there: max |dh| = {e:.3g}")
    return entry, arg, t


def counted_wrappers():
    """Every kernel wrapper, by kernel name."""
    from qinfer_tpu_torch.ops import jacobi as jac
    from qinfer_tpu_torch.ops import precession as prec
    from qinfer_tpu_torch.ops import streaming_resample as sr

    return {"fused_precession_update": prec.fused_precession_update,
            "precession_pr0": prec.precession_pr0,
            "streaming_resample_locations": sr.streaming_resample_locations,
            "jacobi_project_lanes": jac.jacobi_project_lanes,
            "jacobi_project_lanes_looped": jac.jacobi_project_lanes_looped,
            "jacobi_eigh_lanes": jac.jacobi_eigh_lanes}


def run_main_path(torch, dev):
    """Phase 5: the benchmark protocol through the kernels, counted."""
    from qinfer_tpu_torch import bench

    counted = counted_wrappers()
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
        require(all(launches[k] == 0 for k in launches
                    if k.startswith("jacobi")),
                f"a Jacobi kernel ran on the precession path: {launches}")
        say("main", f"run {rep}: {wall:.4f} s, est {est:.6f}, "
                    f"{updater.resample_count} resamples, launches {launches}")
    best = min(walls)
    rate = N_MAIN * bench.N_STEPS / best
    return launches, best, rate


def run_tomography_path(torch, dev, mode, n, steps, card):
    """Phase 5: a tomography path of ``tomography_bench`` (one warm-up, three
    timed repeats), counted. The model's ``projection_count`` (canonicalize
    calls that found a state outside the strict cone) must equal the
    launches of the path's projection kernel, K5 for the process path, K4
    for the diffusive one, and be at least 1; K3 must run once per
    resample; the process path's BCSZ prior draw runs K6 once."""
    from qinfer_tpu_torch import tomography_bench as tb

    cfg = tb.make_config(mode, dev, process_qubits=2)
    counted = counted_wrappers()
    tb.timed_run(cfg, n, steps, 0, dev)  # warm-up
    walls, launches, fids = [], {}, []
    projector = ("jacobi_project_lanes_looped" if mode == "process"
                 else "jacobi_project_lanes")
    for rep in range(tb.N_REPEATS):
        for fn in counted.values():
            fn.launches = 0
        r = tb.timed_run(cfg, n, steps, rep + 1, dev)
        launches = {name: fn.launches for name, fn in counted.items()}
        walls.append(r["wall_s"])
        fids.append(r["fidelity"])
        st = r["state"]
        require(bool(torch.isfinite(st.weights).all())
                and bool(torch.isfinite(st.locations).all())
                and bool(torch.isfinite(st.log_total_likelihood)),
                f"NaN or inf in the state after the {mode} path")
        require(st.locations.shape == (n, cfg.model.n_modelparams),
                f"{mode} path: locations of shape {tuple(st.locations.shape)}")
        require(r["fidelity"] > r["prior_fidelity"],
                f"{mode} path: fidelity {r['fidelity']} not above the prior "
                f"mean's {r['prior_fidelity']}")
        require(r["projections"] >= 1, f"{mode} path: no projection ran")
        require(launches[projector] == r["projections"],
                f"{mode} path: {projector} launched {launches[projector]} "
                f"times for {r['projections']} gated projections")
        require(launches["streaming_resample_locations"]
                == st.resample_count,
                f"{mode} path: K3 launched "
                f"{launches['streaming_resample_locations']} times for "
                f"{st.resample_count} resamples")
        others = {"fused_precession_update", "precession_pr0", projector,
                  "streaming_resample_locations", "jacobi_eigh_lanes"}
        require(all(launches[k] == 0 for k in launches if k not in others),
                f"{mode} path launched another path's kernel: {launches}")
        require(launches["jacobi_eigh_lanes"]
                == (1 if mode == "process" else 0),
                f"{mode} path: K6 launched {launches['jacobi_eigh_lanes']} "
                f"times")
        say("main", f"{mode} run {rep}: {r['wall_s']:.4f} s, fidelity "
                    f"{r['fidelity']:.6f} (prior mean "
                    f"{r['prior_fidelity']:.6f}), {st.resample_count} "
                    f"resamples, {r['projections']} projections, launches "
                    f"{launches}")
    best = min(walls)
    rate = n * steps / best
    say("main", f"{mode}: best of 3 runs: {best:.4f} s for {n} particles x "
                f"{steps} steps = {rate:.6g} particle-updates/s on {card}")
    return launches, fids


def run_moves_path(torch, dev, card, baseline_fids=None, flags=MOVES_PATH,
                   size=MOVES_PATH_SIZE, label="moves",
                   baseline="single-shot process"):
    """Phase 5: the resample-move path, ``tomography_bench --process
    --process-qubits 2`` at ``size`` (particles, steps) with ``flags``
    (``MOVES_PATH``: 64-shot counts, 8 adaptive random-walk sweeps after
    each resample toward acceptance 0.14, the ESS checked every 4th step,
    the moves' own projection off so the resampler keeps its strict one;
    ``EIG_PATH`` adds the experiment design): one warm-up and three timed
    runs, counted. K3 must run once per resample, K5 once per gated
    projection, K6 once (the prior draw), no other path's kernel; one move
    call per resample, mean acceptance in [0.09, 0.19], a finite adapted
    scale and state, and each run's fidelity above the prior mean's and,
    when given, above ``baseline_fids``, the ``baseline`` run of this call
    on the same seed (the same prior draw and seed of the experiment
    stream). With the design, the
    pool's rescore count must be the JAX benchmark's rule (every
    ``--eig-interval``-th step and the step after a resample) applied to
    the run's own resample steps. Returns the last run's launches."""
    from qinfer_tpu_torch import tomography_bench as tb

    n, steps = size
    args = tb.parse_args(flags.split())
    opts = tb.moves_from_args(args)
    design = tb.design_from_args(args)
    cfg = tb.make_config("process", dev, process_qubits=2, design=design)
    counted = counted_wrappers()
    tb.timed_run(cfg, n, tb.WARMUP_STEPS, 0, dev, opts)  # warm-up
    walls, launches = [], {}
    for rep in range(tb.N_REPEATS):
        for fn in counted.values():
            fn.launches = 0
        r = tb.timed_run(cfg, n, steps, rep + 1, dev, opts)
        launches = {name: fn.launches for name, fn in counted.items()}
        walls.append(r["wall_s"])
        st = r["state"]
        require(bool(torch.isfinite(st.weights).all())
                and bool(torch.isfinite(st.locations).all())
                and bool(torch.isfinite(st.log_total_likelihood)),
                f"NaN or inf in the state after the {label} path")
        require(st.locations.shape == (n, 255), f"{label} path: locations "
                f"of shape {tuple(st.locations.shape)}")
        require(st.resample_count >= 1, f"{label} path: no resample")
        require(launches["streaming_resample_locations"]
                == st.resample_count,
                f"{label} path: K3 launched "
                f"{launches['streaming_resample_locations']} times for "
                f"{st.resample_count} resamples")
        require(r["projections"] >= 1
                and launches["jacobi_project_lanes_looped"]
                == r["projections"],
                f"{label} path: K5 launched "
                f"{launches['jacobi_project_lanes_looped']} times for "
                f"{r['projections']} gated projections")
        require(launches["jacobi_eigh_lanes"] == 1,
                f"{label} path: K6 launched {launches['jacobi_eigh_lanes']} "
                "times")
        others = {"streaming_resample_locations",
                  "jacobi_project_lanes_looped", "jacobi_eigh_lanes"}
        require(all(launches[k] == 0 for k in launches if k not in others),
                f"{label} path launched another path's kernel: {launches}")
        require(r["move_calls"] == st.resample_count,
                f"{label} path: {r['move_calls']} move calls for "
                f"{st.resample_count} resamples")
        acc, ls = r["mean_move_acceptance"], r["final_log_scale"]
        require(0.09 <= acc <= 0.19,
                f"{label} path: mean acceptance {acc} outside [0.09, 0.19]")
        require(math.isfinite(ls), f"{label} path: final log scale {ls}")
        require(r["fidelity"] > r["prior_fidelity"],
                f"{label} path: fidelity {r['fidelity']} not above the prior "
                f"mean's {r['prior_fidelity']}")
        beside = ""
        if baseline_fids is not None:
            require(r["fidelity"] > baseline_fids[rep],
                    f"{label} path: fidelity {r['fidelity']} not above the "
                    f"{baseline} run's {baseline_fids[rep]} on the same "
                    f"seed")
            beside = f", {baseline} {baseline_fids[rep]:.6f}"
        rescores = ""
        if design is not None:
            after = {i + 1 for i in r["resample_steps"]}
            want = sum(1 for i in range(steps)
                       if i % design.interval == 0 or i in after)
            require(r["n_rescores"] == want,
                    f"{label} path: {r['n_rescores']} rescores, the JAX "
                    f"rule gives {want}")
            rescores = f", {r['n_rescores']} rescores"
        say("main", f"{label} run {rep}: {r['wall_s']:.4f} s, fidelity "
                    f"{r['fidelity']:.6f} (prior mean "
                    f"{r['prior_fidelity']:.6f}{beside}), {st.resample_count} "
                    f"resamples{rescores}, {r['move_calls']} move calls, mean "
                    f"acceptance {acc:.6f}, final log scale {ls:.6f}, "
                    f"{r['projections']} projections, launches {launches}")
    best = min(walls)
    say("main", f"{label}: best of 3 runs: {best:.4f} s for {n} particles x "
                f"{steps} steps = {n * steps / best:.6g} particle-updates/s "
                f"on {card}")
    return launches


def _recording_resampler(torch):
    """A ``LiuWestResampler(a=0.98)`` that counts its calls and keeps the
    inputs of its first one: the generator's state, the weights and the
    particles."""
    from qinfer_tpu_torch.resamplers import LiuWestResampler

    class Recording(LiuWestResampler):
        calls = 0
        first = None

        def call_with_diagnostics(self, model, generator, w, x):
            self.calls += 1
            if self.first is None:
                self.first = (generator.get_state(), w.clone(), x.clone())
            return super().call_with_diagnostics(model, generator, w, x)

    return Recording(a=0.98)


def _replay_fill(torch, dev, recorded, what):
    """K3 against its plain version on a recorded resample's own inputs
    (its uniform offset replayed from the generator state the resampler
    met): bit-exact, or the phase fails. Returns ``(m, starts, x)``."""
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.resamplers import counting_multiplicities_from_u

    gen_state, w, x = recorded
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    u = torch.rand((), generator=g, device=dev)
    n = x.shape[0]
    m, starts = counting_multiplicities_from_u(u, w, n)
    require(int(m.sum()) == n, f"{what}: K3 counts do not sum to n")
    got = sr.streaming_resample_locations(m, starts, x)
    want = sr.streaming_resample_locations_plain(m, starts, x)
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            f"{what}: K3 not bit-exact on the run's first resample")
    return m, starts, x


def run_config5(torch, dev, card):
    """Phase 5: BASELINE config 5, ``expdesign_bench`` at ``CONFIG5``,
    unchunked and ``CONFIG5_CHUNK`` candidates at a time, counted over its
    warm-up and timed run: K3 once per resample and no other kernel; the
    posterior mean within 0.05 of 0.7. K3 is held bit-exact on the first
    resample's own inputs (its uniform offset replayed from the recorded
    generator state). On the unchunked run's final state: the chunked and
    unchunked information gains agree to √n float32 ulps of a nat (each
    is a difference of two sums over n particles, grouped otherwise when
    the candidate axis is narrower), and
    ``SMCUpdater.expected_information_gain`` with
    ``candidate_chunk=64`` peaks at the same memory (within 10 %) for
    256 and for 1024 candidates. Returns K3's timing entry at the
    recorded resample's shape."""
    from qinfer_tpu_torch import expdesign_bench as eb
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.smc import (SMCUpdater, _expected_information_gain,
                                      score_candidates)
    from qinfer_tpu_torch import SimplePrecessionModel, UniformDistribution

    n, steps, n_cand = CONFIG5
    counted = counted_wrappers()
    finals = {}
    for chunk in (0, CONFIG5_CHUNK):
        rs = _recording_resampler(torch)
        for fn in counted.values():
            fn.launches = 0
        r = eb.run_bench(n, steps, n_cand, chunk, dev, resampler=rs)
        launches = {name: fn.launches for name, fn in counted.items()}
        est = r["posterior_mean"]
        require(abs(est - 0.7) < 0.05,
                f"config 5 (chunk {chunk}): posterior mean {est}")
        require(launches["streaming_resample_locations"] == rs.calls >= 1,
                f"config 5: K3 launched "
                f"{launches['streaming_resample_locations']} times for "
                f"{rs.calls} resamples")
        require(all(v == 0 for k, v in launches.items()
                    if k != "streaming_resample_locations"),
                f"config 5 launched another path's kernel: {launches}")
        say("main", f"config 5 chunk {chunk}: {r['wall_s']:.4f} s for {n} "
                    f"particles x {steps} steps x {n_cand} candidates = "
                    f"{r['particle_updates_per_s']:.6g} particle-updates/s, "
                    f"{r['candidate_scores_per_s']:.6g} candidate-scores/s, "
                    f"posterior mean {est:.6f}, {r['resamples']} resamples "
                    f"(timed run), peak memory {r['peak_memory_bytes']} B, "
                    f"launches over warm-up and timed run {launches} on "
                    f"{card}")
        finals[chunk] = (r["state"], rs.first)

    state, recorded = finals[0]
    m, starts, x = _replay_fill(torch, dev, recorded, "config 5")

    model = SimplePrecessionModel()
    cand = {"t": eb.candidate_spread(n_cand, dev) * 20.0}
    scores = [score_candidates(_expected_information_gain, model,
                               state.weights, state.locations, cand,
                               candidate_chunk=c)
              for c in (None, CONFIG5_CHUNK)]
    diff = float((scores[0] - scores[1]).abs().max())
    tol = 2.0 ** -24 * math.sqrt(n)
    require(diff <= tol, f"config 5: chunked and unchunked scores differ by "
                         f"{diff} (tolerance {tol:.3g})")

    chunk, pools = CONFIG5_MEMORY
    updater = SMCUpdater(model, n, UniformDistribution([[0.0, 1.0]]),
                         device=dev)
    updater.state = state
    peaks = []
    for n_pool in pools:
        pool = {"t": torch.linspace(0.5, 60.0, n_pool, device=dev)}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ig = updater.expected_information_gain(pool, candidate_chunk=chunk)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        require(ig.shape == (n_pool,) and bool(torch.isfinite(ig).all()),
                f"config 5: information gain of {n_pool} candidates")
    require(abs(peaks[1] - peaks[0]) <= 0.1 * peaks[0],
            f"config 5: chunked scoring peaks at {peaks[0]} B for "
            f"{pools[0]} candidates and {peaks[1]} B for {pools[1]}")
    table = 2 * n * chunk * 4
    say("main", f"config 5: K3 bit-exact on the first resample "
                f"(n = {n}, d = 1); chunked vs unchunked scores max |Δ| "
                f"{diff:.3g} (tolerance {tol:.3g}); candidate_chunk={chunk} "
                f"peaks "
                f"{peaks[0]} B at {pools[0]} candidates and {peaks[1]} B at "
                f"{pools[1]} ({peaks[0] / table:.3f} and "
                f"{peaks[1] / table:.3f} (2, n, chunk) float32 tables)")
    return timed(
        f"streaming_resample_locations n={n}, d=1 (config 5's first "
        f"resample)",
        lambda: sr.streaming_resample_locations(m, starts, x),
        lambda: sr.streaming_resample_locations_plain(m, starts, x),
        library=lambda: torch.repeat_interleave(x, m, dim=0, output_size=n),
        bound_at=bound(4 * n + 8 * n, 0))


def run_models_path(torch, dev, card):
    """Phase 5: the models path, ``models_bench`` at ``MODELS`` (BASELINE
    configs 2 and 3 through ``SMCUpdater.batch_update``), with every launch
    count set to 0 just before each timed call and read just after: K3
    once per resample (at least one) and no other kernel. Each posterior
    mean within 4 sd of the truth (``max_z_vs_true``); config 3's credible
    set, hull vertices and MVEE ``(A, c)`` finite, and whether the truth
    lies in the ``hpd_mvee`` region printed. K3 bit-exact on the first
    resample of each config. Then ``simple_est_rb`` at its defaults on a
    synthetic 32-experiment record, counted the same way. Returns K3's
    timing entries at the two configs' shapes, to attach to K3's result."""
    import numpy as np
    from qinfer_tpu_torch import models_bench as mb
    from qinfer_tpu_torch import simple_est_rb
    from qinfer_tpu_torch.ops import streaming_resample as sr

    n, repeats = MODELS
    counted = counted_wrappers()
    runs, recorders = [], []

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(updater):
        runs.append(({name: fn.launches for name, fn in counted.items()},
                     updater.resample_count))

    def make_resampler():
        recorders.append(_recording_resampler(torch))
        return recorders[-1]

    results = mb.run_bench(n, repeats, dev, make_resampler=make_resampler,
                           before_run=zero_counts, after_run=read_counts)
    entries = []
    for i, (u, rec) in enumerate(results):
        tag = rec["metric"].split("_particle")[0]
        cfg_runs = runs[mb.N_TIMED * i:mb.N_TIMED * (i + 1)]
        for launches, resamples in cfg_runs:
            require(launches["streaming_resample_locations"] == resamples
                    >= 1, f"models path {tag}: K3 launched "
                    f"{launches['streaming_resample_locations']} times for "
                    f"{resamples} resamples")
            require(all(v == 0 for k, v in launches.items()
                        if k != "streaming_resample_locations"),
                    f"models path {tag} launched another kernel: {launches}")
        st = u.state
        require(bool(torch.isfinite(st.weights).all())
                and bool(torch.isfinite(st.locations).all())
                and math.isfinite(u.log_total_likelihood),
                f"models path {tag}: NaN or inf in the state")
        require(rec["max_z_vs_true"] <= 4.0, f"models path {tag}: "
                f"max_z_vs_true {rec['max_z_vs_true']} above 4")
        m, starts, x = _replay_fill(torch, dev, recorders[i].first,
                                    f"models path {tag}")
        nn, d = x.shape
        k3 = [c["streaming_resample_locations"] for c, _ in cfg_runs]
        say("main", f"models {tag}: best of {mb.N_TIMED} {rec['wall_s']:.4f}"
                    f" s ({rec['repeat_walls_s']}) for {nn} particles x "
                    f"{rec['n_experiments']} experiments = "
                    f"{rec['value']:.6g} particle-updates/s, resamples per "
                    f"run {[r for _, r in cfg_runs]}, K3 launches {k3}"
                    f", max_z_vs_true {rec['max_z_vs_true']:.4f}, est "
                    f"{rec['est']}; K3 bit-exact on the first resample "
                    f"(n = {nn}, d = {d}) on {card}")
        entries.append(timed(
            f"streaming_resample_locations n={nn}, d={d} (models path, "
            f"{tag}'s first resample)",
            lambda m=m, s=starts, x=x: sr.streaming_resample_locations(
                m, s, x),
            lambda m=m, s=starts, x=x: sr.streaming_resample_locations_plain(
                m, s, x),
            library=lambda m=m, x=x, nn=nn: torch.repeat_interleave(
                x, m, dim=0, output_size=nn),
            bound_at=bound(4 * nn + 8 * nn * d, 0),
            attach=dict(kernel="streaming_resample_locations",
                        launches=cfg_runs[-1][0][
                            "streaming_resample_locations"])))

    u3, rec3 = results[1]
    region = rec3["region_est"]
    pts = u3.est_credible_region(0.95)
    vertices, _ = u3.region_est_hull(0.95)
    A, c = u3.region_est_ellipsoid(0.95)
    require(pts.shape[0] >= 4 and bool(np.isfinite(pts).all()),
            f"models path rb: credible set of shape {pts.shape}")
    require(bool(np.isfinite(vertices).all()) and vertices.shape[0] >= 4,
            f"models path rb: hull vertices of shape {vertices.shape}")
    require(bool(np.isfinite(A).all()) and bool(np.isfinite(c).all()),
            "models path rb: the MVEE (A, c) is not finite")
    true3 = mb.make_configs(1)[1].true
    inside = bool(u3.in_credible_region(true3, 0.95, method="hpd_mvee")[0])
    say("main", f"models rb region: {region['credible_points']} credible "
                f"points, {vertices.shape[0]} hull vertices, MVEE center "
                f"{c.tolist()}, query {region['wall_s']:.4f} s; the truth "
                f"{true3.tolist()} is {'inside' if inside else 'OUTSIDE'} "
                f"the hpd_mvee region")

    rng = np.random.default_rng(11)
    ms = np.tile([1, 2, 4, 8, 16, 32, 64, 128], 4)
    counts = rng.binomial(30, 0.4 * 0.95 ** ms + 0.5)
    data = np.stack([counts, ms, np.full(len(ms), 30)], 1).astype(float)
    zero_counts()
    t0 = time.perf_counter()
    mean, cov, extra = simple_est_rb(data, return_all=True, device=dev)
    wall = time.perf_counter() - t0
    u = extra["updater"]
    k3 = counted["streaming_resample_locations"].launches
    require(mean.shape == (3,) and bool(np.isfinite(mean).all())
            and bool(np.isfinite(cov).all()),
            f"simple_est_rb: mean {mean}, cov {cov}")
    require(k3 == u.resample_count >= 1, f"simple_est_rb: K3 launched {k3} "
            f"times for {u.resample_count} resamples")
    say("main", f"simple_est_rb (8000 particles, 32 experiments): mean "
                f"{mean.tolist()}, sd {np.sqrt(np.diag(cov)).tolist()}, "
                f"{u.resample_count} resamples = K3 launches, {wall:.4f} s "
                f"with the updater's set-up")
    return entries


#: the item-8 phase: the kernels a run may launch besides K3, and the runs
#: that may end without a resample (one step each)
ITEM8_EXTRA_KERNELS = {"tomography_gadfli": {"jacobi_project_lanes"},
                       "tomography_ginibre": {"jacobi_project_lanes"}}
ITEM8_MAY_SKIP_RESAMPLE = {"poisson_mle_step", "poisson_poisoned_step"}


def run_item8_path(torch, dev, card):
    """Phase 5: the item-8 runs (``item8_bench.run_all``: drift tracking
    with a fixed and a learned walk, the multinomial die, ALE,
    referenced-Poisson readout with one MLE and one poisoned step, and
    GADFLI-prior two-qubit state tomography with a Ginibre run beside it),
    with every launch count set to 0 just before each timed loop and read
    just after. Each run: K3 once per resample (at least once for the five
    runs), no other kernel but K4 on the tomography runs, where K4
    launches once per gated projection; a finite state; the run's own
    checks (``bars``: |mean − truth| ≤ 4 sd, ``max_z_vs_true`` ≤ 4, the
    ALE twin steps' normalizations differing, the GADFLI run's fidelity
    above its prior mean's); K3 bit-exact on its first resample. Returns
    K3's timing entries at the runs' new shapes, and K4's launches on the
    GADFLI run."""
    import numpy as np
    from qinfer_tpu_torch import item8_bench as ib
    from qinfer_tpu_torch.ops import streaming_resample as sr

    counted = counted_wrappers()
    recorders = []

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(rec):
        rec["launches"] = {name: fn.launches for name, fn in counted.items()}

    def make_resampler():
        recorders.append(_recording_resampler(torch))
        return recorders[-1]

    t0 = time.perf_counter()
    records = ib.run_all(ib.N_PARTICLES, ib.N_TOMO, dev,
                         make_resampler=make_resampler,
                         before_run=zero_counts, after_run=read_counts)
    phase_wall = time.perf_counter() - t0
    require(len(records) == len(recorders), "item 8: one resampler a run")
    entries, shapes, k4_launches = [], set(), None
    for rec, recorder in zip(records, recorders):
        name, launches = rec["run"], rec["launches"]
        u = rec["updater"]
        k3 = launches["streaming_resample_locations"]
        require(k3 == rec["resamples"] == recorder.calls,
                f"item 8 {name}: K3 launched {k3} times for "
                f"{rec['resamples']} resamples")
        require(k3 >= 1 or name in ITEM8_MAY_SKIP_RESAMPLE,
                f"item 8 {name}: no resample")
        allowed = {"streaming_resample_locations"} | ITEM8_EXTRA_KERNELS.get(
            name, set())
        require(all(v == 0 for k, v in launches.items() if k not in allowed),
                f"item 8 {name} launched another path's kernel: {launches}")
        if "projections" in rec:
            require(launches["jacobi_project_lanes"] == rec["projections"],
                    f"item 8 {name}: K4 launched "
                    f"{launches['jacobi_project_lanes']} times for "
                    f"{rec['projections']} gated projections")
            if name == "tomography_gadfli":
                k4_launches = launches["jacobi_project_lanes"]
        st = u.state
        require(bool(torch.isfinite(st.weights).all())
                and bool(torch.isfinite(st.locations).all())
                and math.isfinite(u.log_total_likelihood),
                f"item 8 {name}: NaN or inf in the state")
        for what, value, bar, ok in rec["bars"]:
            require(ok, f"item 8 {name}: {what} = {value} against {bar}")
        if recorder.first is not None:
            m, starts, x = _replay_fill(torch, dev, recorder.first,
                                        f"item 8 {name}")
            nn, d = x.shape
            if d not in shapes:
                shapes.add(d)
                entries.append(timed(
                    f"streaming_resample_locations n={nn}, d={d} (item 8, "
                    f"{name}'s first resample)",
                    lambda m=m, s=starts, x=x:
                        sr.streaming_resample_locations(m, s, x),
                    lambda m=m, s=starts, x=x:
                        sr.streaming_resample_locations_plain(m, s, x),
                    library=lambda m=m, x=x, nn=nn: torch.repeat_interleave(
                        x, m, dim=0, output_size=nn),
                    bound_at=bound(4 * nn + 8 * nn * d, 0),
                    attach=dict(kernel="streaming_resample_locations",
                                launches=k3)))
        extra = {k: rec[k] for k in (
            "truth", "est", "learned_sigma", "max_z_vs_true", "min_n_ess",
            "redraw_rounds", "n_samples", "twin_normalizations",
            "last_signal_t", "fidelity", "prior_fidelity", "projections")
            if k in rec}
        if "rounds_per_step" in rec:
            r = np.asarray(rec["rounds_per_step"])
            extra["ale_rounds_per_step"] = (
                f"min {r.min()}, mean {r.mean():.2f}, max {r.max()} over "
                f"{r.size} steps ({int(r.sum())} rounds, one host sync "
                f"each)")
        say("main", f"item 8 {name}: {rec['wall_s']:.4f} s for "
                    f"{rec['n_particles']} particles x {rec['steps']} steps "
                    f"= {rec['particle_updates_per_s']:.6g} "
                    f"particle-updates/s, {rec['resamples']} resamples, "
                    f"launches {launches}, K3 bit-exact on the first "
                    f"resample; {json.dumps(extra, default=str)}; bars "
                    f"{rec['bars']} on {card}")
    require(k4_launches is not None and k4_launches >= 1,
            "item 8: K4 did not run on the GADFLI tomography run")
    say("main", f"item 8: {len(records)} runs in {phase_wall:.1f} s with "
                f"their set-up on {card}")
    return entries, k4_launches


def _recording_batch_resampler(torch):
    """A ``LiuWestResampler(a=0.98)`` that counts its batched calls and
    the rows they resample, and keeps the inputs of its first call over
    two or more trials: the generator's state, the weights and the
    particles."""
    from qinfer_tpu_torch.resamplers import LiuWestResampler

    class Recording(LiuWestResampler):
        calls = 0
        rows = 0
        first = None

        def call_batch_with_diagnostics(self, model, generator, w, x):
            self.calls += 1
            self.rows += w.shape[0]
            if self.first is None and w.shape[0] >= 2:
                self.first = (generator.get_state(), w.clone(), x.clone())
            return super().call_batch_with_diagnostics(model, generator, w,
                                                       x)

    return Recording(a=0.98)


def _recording_k1_model(keep_from):
    """An ``AcceleratedPrecessionModel`` that counts its reweights and
    keeps the K1 inputs (ω, w, t, outcome) of every call from the
    ``keep_from``-th on: with T trials and S steps, ``keep_from`` =
    (S − 1)·T keeps each trial's last step."""
    from qinfer_tpu_torch import AcceleratedPrecessionModel

    class Recording(AcceleratedPrecessionModel):
        def __init__(self):
            super().__init__()
            self.calls, self.kept = 0, []

        def fused_reweight(self, weights, locations, outcome, expparams):
            if self.calls >= keep_from:
                self.kept.append((locations[:, 0].clone(), weights.clone(),
                                  float(expparams["t"].reshape(-1)[0]),
                                  int(outcome.reshape(-1)[0])))
            self.calls += 1
            return super().fused_reweight(weights, locations, outcome,
                                          expparams)

    return Recording()


def _replay_batch_fill(torch, dev, recorded):
    """A recorded batched resample's fill replayed from its inputs (the
    per-trial offsets drawn again from the generator state it met): the
    one K3 launch over the flat rows against the plain twin, and against
    each trial's own K3 launch on its rows, to the bit. Each row's counts
    sum to n; the counts of a 1-D call on the same offset and weights are
    compared too (a 1-D cumsum on the card is another summation order, so
    a span boundary may move by one slot) and the moved slots printed.
    Returns ``(m, starts, flat rows, T')``."""
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.resamplers import (counting_locations_batch_from_u,
                                             counting_multiplicities_from_u)

    gen_state, w, x = recorded
    tp, n, d = x.shape
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    u = torch.rand((tp,), generator=g, device=dev)
    x_anc, m, starts = counting_locations_batch_from_u(u, w, x)
    flat = x.reshape(tp * n, d)
    require(torch.equal(m.reshape(tp, n).sum(dim=1),
                        torch.full((tp,), n, device=dev)),
            "trials: a row's counts do not sum to n")
    plain = sr.streaming_resample_locations_plain(m, starts, flat)
    require(torch.equal(plain.view(torch.int32),
                        x_anc.reshape(tp * n, d).view(torch.int32)),
            "trials: the batched K3 fill differs from the plain twin")
    moved, shift = 0, 0
    for t in range(tp):
        rows = slice(t * n, (t + 1) * n)
        alone = sr.streaming_resample_locations(
            m[rows].contiguous(), (starts[rows] - t * n).contiguous(),
            x[t].contiguous())
        require(torch.equal(alone.view(torch.int32),
                            x_anc[t].view(torch.int32)),
                f"trials: trial {t}'s own K3 fill differs from its rows of "
                "the batched fill")
        m1, s1 = counting_multiplicities_from_u(u[t], w[t], n)
        moved += int((m1 != m[rows]).sum())
        shift = max(shift, int((s1 - (starts[rows] - t * n)).abs().max()))
    say("main", f"trials: a batched K3 call over {tp} trials x {n} rows "
                f"replayed: equal to the plain twin and to each trial's own "
                f"K3 fill to the bit; 1-D counts on the same offsets move "
                f"{moved} counts, first slots by at most {shift}")
    return m, starts, flat, tp


def run_trials_path(torch, dev, card):
    """Phase 5: the trial engines at the JAX trials benchmark's width
    (``TRIALS``: 32 trials x 131 072 particles x 256 steps, seed 11,
    ``SimplePrecessionModel`` + PGH): batched at each of
    ``TRIALS_INTERVALS`` and sequential on a one-card mesh at interval 0,
    with every launch count set to 0 just before each run and read just
    after. Each run: the median |estimate − truth| at the last step below
    0.05 and the median last/first loss ratio below 1e-2; K3 once per
    step in which at least one trial resampled (batched: the resampler's
    batched calls, whose rows add up to the trials' resamples) or once per
    resample (sequential); no other kernel. One recorded batched K3 call
    (:func:`_replay_batch_fill`). Then one batched run of ``TRIALS_K1``
    with ``AcceleratedPrecessionModel``: K1 and K2 once per trial and
    step, and K1 held against its plain version (:func:`hold_k1`) on the
    inputs each trial's last step gave it. Returns the timing entries of
    K3 at the replayed shape and of K1 at the trial with the largest
    |ω·t/2| of those inputs, and K1's launches on the accelerated run."""
    from qinfer_tpu_torch import SimplePrecessionModel, UniformDistribution
    from qinfer_tpu_torch.ops import precession as prec
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.perf_testing import perf_test_scan_batch
    from qinfer_tpu_torch.resamplers import LiuWestResampler

    import numpy as np

    counted = counted_wrappers()
    prior = UniformDistribution([[0.0, 1.0]])
    t_phase = time.perf_counter()
    recorded, k3_batched = None, None

    def one_run(model, size, interval, mesh, resampler):
        T, n, steps = size
        runner, seeds = perf_test_scan_batch(
            model, n, prior, steps, T, resampler=resampler, seed=TRIALS_SEED,
            mesh=mesh, resample_interval=interval, return_runner=True,
            device=dev)
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = runner(seeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        est = rec["est"][:, -1, :].cpu().numpy()
        true = rec["true_mps"].cpu().numpy()
        loss = rec["loss"].cpu().numpy()
        err = float(np.median(np.abs(est - true)))
        ratio = float(np.median(loss[:, -1] / np.maximum(loss[:, 0], 1e-30)))
        require(bool(torch.isfinite(rec["final_weights"]).all())
                and bool(torch.isfinite(rec["final_locations"]).all()),
                "trials: NaN or inf in the final ensembles")
        require(err < 0.05, f"trials: median |est - true| {err} at the last "
                            "step, not below 0.05")
        require(ratio < 1e-2, f"trials: median loss ratio {ratio}, not "
                              "below 1e-2")
        return rec, runner.resample_counts, launches, wall, err, ratio

    T, n, steps = TRIALS
    for label, interval in ([("batched", i) for i in TRIALS_INTERVALS]
                            + [("sequential", 0)]):
        mesh = [dev] if label == "sequential" else None
        rs = (_recording_batch_resampler(torch) if mesh is None
              else LiuWestResampler(a=0.98))
        rec, counts, launches, wall, err, ratio = one_run(
            SimplePrecessionModel(), TRIALS, interval, mesh, rs)
        k3 = launches["streaming_resample_locations"]
        if mesh is None:
            require(k3 == rs.calls >= 1 and rs.rows == sum(counts),
                    f"trials batched interval {interval}: K3 launched {k3} "
                    f"times for {rs.calls} steps that resampled "
                    f"({rs.rows} rows, {sum(counts)} resamples)")
            require(rs.calls <= (steps if interval == 0
                                 else steps // interval),
                    f"trials: {rs.calls} resampling steps of {steps}")
            if interval == 0:
                recorded, k3_batched = rs.first, k3
        else:
            require(k3 == sum(counts) >= 1,
                    f"trials sequential: K3 launched {k3} times for "
                    f"{sum(counts)} resamples")
        require(all(v == 0 for k, v in launches.items()
                    if k != "streaming_resample_locations"),
                f"trials {label} launched another kernel: {launches}")
        say("main", f"trials {label} interval {interval}: {wall:.4f} s for "
                    f"{T} trials x {n} particles x {steps} steps = "
                    f"{T * n * steps / wall:.6g} aggregate updates/s "
                    f"({n * steps / wall:.6g} a trial), median |est - true| "
                    f"{err:.6g}, median loss ratio {ratio:.6g}, resamples a "
                    f"trial min {min(counts)} / mean "
                    f"{sum(counts) / len(counts):.2f} / max {max(counts)}, "
                    f"K3 launches {k3} on {card}")
    require(recorded is not None, "trials: no batched resample over two or "
                                  "more trials to replay")
    m, starts, flat, tp = _replay_batch_fill(torch, dev, recorded)

    Tk, nk, sk = TRIALS_K1
    rs = _recording_batch_resampler(torch)
    model = _recording_k1_model((sk - 1) * Tk)
    _, counts, launches, wall, err, ratio = one_run(
        model, TRIALS_K1, 0, None, rs)
    k1 = launches["fused_precession_update"]
    require(k1 == Tk * sk == model.calls,
            f"trials accelerated: K1 launched {k1} times in "
            f"{model.calls} reweights, not {Tk} x {sk}")
    require(launches["precession_pr0"] == Tk * sk,
            f"trials accelerated: K2 launched {launches['precession_pr0']} "
            f"times, not {Tk} x {sk}")
    require(launches["streaming_resample_locations"] == rs.calls,
            f"trials accelerated: K3 launched "
            f"{launches['streaming_resample_locations']} times for "
            f"{rs.calls} resampling steps")
    say("main", f"trials accelerated batched: {wall:.4f} s for {Tk} trials "
                f"x {nk} particles x {sk} steps = {Tk * nk * sk / wall:.6g} "
                f"aggregate updates/s, median |est - true| {err:.6g}, "
                f"launches {launches} on {card}")
    # K1 on each trial's last-step inputs, as the run launched it
    k1_err, worst = 0.0, None
    for trial, (omega, w, t, outcome) in enumerate(model.kept):
        k1_err = max(k1_err, hold_k1(
            omega, w, t, outcome,
            f"on trial {trial}'s last step of the accelerated trials run"))
        arg = float(omega.abs().max()) * t / 2
        if worst is None or arg > worst[0]:
            worst = (arg, trial, omega, w, t, outcome)
    require(len(model.kept) == Tk, f"trials accelerated: kept "
                                   f"{len(model.kept)} last steps, not {Tk}")
    arg, trial, omega, w, t, outcome = worst
    say("main", f"trials accelerated: K1 on the {Tk} trials' last steps "
                f"(n = {nk}) against its plain version: max |dh| = "
                f"{k1_err:.3g}; largest |ω·t/2| = {arg:.6g} (trial {trial}, "
                f"t = {t:.6g})")
    say("main", f"trials phase: {time.perf_counter() - t_phase:.1f} s with "
                f"its set-up")
    rows = tp * TRIALS[1]
    entry = timed(
        f"streaming_resample_locations n={rows}, d=1 (trials: one batched "
        f"launch over {tp} trials)",
        lambda: sr.streaming_resample_locations(m, starts, flat),
        lambda: sr.streaming_resample_locations_plain(m, starts, flat),
        library=lambda: torch.repeat_interleave(flat, m, dim=0,
                                                output_size=rows),
        bound_at=bound(4 * rows + 8 * rows, 0),
        attach=dict(kernel="streaming_resample_locations",
                    launches=k3_batched))
    # bound: ω and w read, h written; ~10 operations a particle (cosf as 1)
    k1_entry = timed(
        f"fused_precession_update n={nk} (trials accelerated: trial "
        f"{trial}'s last step, t = {t:.6g}, outcome {outcome})",
        lambda: prec.fused_precession_update(omega, w, t, outcome,
                                             normalize=False),
        lambda: prec.fused_precession_update_plain(omega, w, t, outcome,
                                                   normalize=False),
        no_library="no one PyTorch call fuses the reweight and its sums",
        bound_at=bound(12 * nk, 10 * nk),
        attach=dict(kernel="fused_precession_update", launches=k1,
                    max_abs_err=k1_err))
    return [entry, k1_entry], k1


def run_resume_path(torch, dev, card):
    """Phase 5: checkpoint and resume on the resample-move recipe
    (``MOVES_PATH``'s flags through ``SMCUpdater``: 64-shot binomial
    process tomography of the depolarized two-qubit channel, 8 adaptive
    Metropolis sweeps over the compressed record after each resample, the
    ESS checked every 4th step) at ``RESUME``: updater A takes 200 steps,
    is saved to a temporary file and loaded into updater B, built with
    another seed; then A and B take the same 200 further steps (the
    experiments and outcomes drawn once, up front, from the phase's own
    generator). After every step B must equal A to the bit: weights,
    locations, ``resample_count``, ``_mcmc_log_scale`` and ``_n_record``.
    The comparison runs in PyTorch's default mode, with no
    ``torch.use_deterministic_algorithms``: the port itself must be
    reproducible (a CUDA cumsum over one row is not, so the port scans a
    row by ``utils.cumsum_last``). K3 launches once per resample, K5 once per gated projection, K6 once a
    prior draw (two updaters). Returns the launches."""
    import tempfile

    from qinfer_tpu_torch import BinomialModel, SMCUpdater
    from qinfer_tpu_torch import tomography_bench as tb
    from qinfer_tpu_torch.checkpoint import load_updater, save_updater

    n, before, after = RESUME
    opts = tb.moves_from_args(tb.parse_args(MOVES_PATH.split()))
    cfg = tb.make_config("process", dev, process_qubits=2)
    model = BinomialModel(cfg.model, n_meas_max=opts.shots)
    counted = counted_wrappers()

    def make(seed):
        return SMCUpdater(
            model, n, cfg.prior, resampler=opts.resampler(),
            n_mcmc_moves=opts.moves, compress_mcmc_record=True,
            mcmc_canonicalize=not opts.no_move_canonicalize,
            mcmc_adapt=opts.adapt, mcmc_target_accept=opts.target_accept,
            zero_weight_policy="reset", seed=seed, device=dev)

    g = torch.Generator(device=dev)
    g.manual_seed(2024)
    shots = torch.full((1,), opts.shots, dtype=torch.int32, device=dev)
    true = cfg.true_mps.to(dev)
    record = []
    for idx in range(before + after):
        eps, _ = cfg.propose(g, idx, None, None)
        eps = dict(eps, n_meas=shots)
        record.append((model.simulate_experiment(g, true, eps).reshape(-1)[:1],
                       eps))

    def step(u, idx):
        o, eps = record[idx]
        u.update(o, eps, check_for_resample=(idx % opts.interval
                                             == opts.interval - 1))

    for fn in counted.values():
        fn.launches = 0
    cfg.model.projection_count = 0
    t0 = time.perf_counter()
    a = make(1)
    for idx in range(before):
        step(a, idx)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.npz")
        t1 = time.perf_counter()
        save_updater(path, a)
        size = os.path.getsize(path)
        b = make(2)
        load_updater(path, b)
        torch.cuda.synchronize()
        wall_io = time.perf_counter() - t1
    saved_resamples = a.resample_count
    t2 = time.perf_counter()
    for idx in range(before, before + after):
        step(a, idx)
        step(b, idx)
        require(torch.equal(a.particle_weights, b.particle_weights)
                and torch.equal(a.particle_locations, b.particle_locations)
                and a.resample_count == b.resample_count
                and a._mcmc_log_scale == b._mcmc_log_scale
                and a._n_record == b._n_record,
                f"resume: B differs from A at step {idx}")
    torch.cuda.synchronize()
    wall_ab = time.perf_counter() - t2
    launches = {name: fn.launches for name, fn in counted.items()}
    resamples = a.resample_count + (b.resample_count - saved_resamples)
    require(launches["streaming_resample_locations"] == resamples >= 2,
            f"resume: K3 launched {launches['streaming_resample_locations']}"
            f" times for {resamples} resamples")
    require(launches["jacobi_project_lanes_looped"]
            == cfg.model.projection_count >= 1,
            f"resume: K5 launched {launches['jacobi_project_lanes_looped']} "
            f"times for {cfg.model.projection_count} gated projections")
    require(launches["jacobi_eigh_lanes"] == 2,
            f"resume: K6 launched {launches['jacobi_eigh_lanes']} times for "
            "two prior draws")
    fid = tb.fidelity(cfg.model, a.particle_locations, a.particle_weights,
                      true)
    say("main", f"resume: A took {before} steps in {wall_a:.4f} s, saved "
                f"({size} B) and loaded into B in {wall_io:.4f} s; A and B "
                f"took {after} more steps each in {wall_ab:.4f} s, equal to "
                f"the bit after every step; fidelity at step "
                f"{before + after} {fid:.6f}, {a.resample_count} resamples, "
                f"log scale {a._mcmc_log_scale:.6f}; K3 "
                f"{launches['streaming_resample_locations']}, K5 "
                f"{launches['jacobi_project_lanes_looped']}, K6 "
                f"{launches['jacobi_eigh_lanes']} launches on {card}")
    return launches


def main(argv):
    kernels_only = argv == ["--kernels-only"]
    require(not argv or kernels_only,
            f"usage: chip_smoke.py [--kernels-only], got {argv}")
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
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]
    say("build", f"{os.path.relpath(lib_path, ROOT)} in "
                 f"{time.perf_counter() - t0:.1f} s; ptxas: {regs}")
    # the main paths' Jacobi instances (d, matrices a warp, projection):
    # registers and any local memory (a nonzero stack frame or spill)
    for d, g, proj, what in ((8, 4, 1, "K4"), (16, 2, 1, "K4"),
                             (32, 1, 1, "K5"), (8, 4, 0, "K6")):
        tag = f"jacobi_warp_kernelILi{d}ELi{g}ELb{proj}E"
        part = log.split(tag, 1)[-1].split("Compiling", 1)[0]
        say("build", f"{what} warp kernel, d = {d}, {g} a warp: " + "; ".join(
            ln.strip() for ln in part.splitlines()
            if "stack frame" in ln or "registers" in ln))

    timers, extra = check_kernels(torch, dev)
    jac_timers, jac_extra = check_jacobi_kernels(torch, dev)
    if kernels_only:
        results = time_kernels(timers + jac_timers, extra + jac_extra)
        print(json.dumps({"kernels": results}))
        print(card)
        return
    check_engine(torch, dev)
    launches, best, rate = run_main_path(torch, dev)
    say("main", f"best of 3 runs: {best:.4f} s for "
                f"{N_MAIN} particles x 256 steps = {rate:.6g} "
                f"particle-updates/s on {card}")
    path_launches, path_fids = {}, {}
    for mode, n, steps in TOMO_PATHS:
        path_launches[mode], path_fids[mode] = run_tomography_path(
            torch, dev, mode, n, steps, card)
    run_moves_path(torch, dev, card, path_fids["process"])
    run_moves_path(torch, dev, card, flags=EIG_PATH, size=EIG_PATH_SIZE,
                   label="eig flagship")
    extra.append(run_config5(torch, dev, card))
    extra.extend(run_models_path(torch, dev, card))
    item8_entries, item8_k4 = run_item8_path(torch, dev, card)
    extra.extend(item8_entries)
    trials_entries, trials_k1 = run_trials_path(torch, dev, card)
    extra.extend(trials_entries)
    resume_launches = run_resume_path(torch, dev, card)
    extra.append(late_step_k1(torch, dev)[0])
    results = time_kernels(timers + jac_timers, extra + jac_extra)
    require("jax" not in sys.modules, "JAX was imported")

    # each kernel's count from the run of the path that carries it
    path_of = {"jacobi_project_lanes": "diffusive",
               "jacobi_project_lanes_looped": "process",
               "jacobi_eigh_lanes": "process"}
    for r in results:
        path = path_of.get(r["name"])
        r["launches"] = (path_launches[path] if path else launches)[r["name"]]
    next(r for r in results if r["name"] == "jacobi_project_lanes")[
        "launches_item8_gadfli"] = item8_k4
    next(r for r in results if r["name"] == "fused_precession_update")[
        "launches_trials_accelerated"] = trials_k1
    for r in results:
        if resume_launches[r["name"]]:
            r["launches_resume"] = resume_launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
