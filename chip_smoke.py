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
   d = 255, bit-exact on raw bit patterns; the counting pass at 2²², at
   50 000 and on 12 rows of 131 072, equal to its plain version to the bit
   on integer weights and within one slot of the float64 count on random
   ones; the Jacobi kernels K4-K6, equal
   to their plain versions to the bit, on embedded Ginibre/BCSZ states
   pushed out of the PSD cone as Liu-West proposals are, and on random
   symmetric matrices, also against host float64 ``numpy.linalg.eigh`` on
   a subsample), with the tolerance stated; beside them, K4 at the
   flagship leg's (65 536, 8, 8), ``torch.linalg.eigh`` (K6's library
   call) at (50 000, 16, 16) or its refusal, and the projection past the
   Jacobi kernels' d = 32 (``torch.linalg.eigh`` and the rebuild, the
   route a ``PerformanceWarning`` announces) once at (50 000, 64, 64);
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
   Then the parallel phase, 8 shards of one ensemble on the card
   (``ParticleMesh([dev] * 8)``): ``perf_test_scan`` at 2²² x 256 with
   ``AcceleratedPrecessionModel`` and the two-level
   ``DistributedLiuWestResampler``, by the ring and by the butterfly
   under one seed (|est − 0.7| < 0.05, the final states equal to the bit,
   K1 and K2 once a step, K3 ONE launch a resample over all 8 shards'
   rows), one resample timed by each route and by the plain Liu-West,
   the ring's first fill replayed (each shard receives its ancestor's
   block; K3 equal to its plain twin and to each shard's own fill),
   BASELINE config 5 sharded over the 8 shards equal to the unsharded
   run to the bit, and ``scaling_bench``'s precession and flagship legs at
   1 and 8 shards (fidelity at least 0.90); each kernel's launches there
   go under ``launches_parallel`` (K1-K3: the ring run; K4-K6: the
   flagship leg at 8 shards).
   Then the process phase: one ensemble over 2 ranks of a
   ``torch.distributed`` group, each a process of
   ``qinfer_tpu_torch.parallel.worker`` on the card (gloo, staged
   through host memory: NCCL refuses two ranks on one card): the sharded
   precession run of the parallel phase at 2²² x 256 by the ring and by
   the butterfly, and config 5; the ranks equal to the bit, ring =
   butterfly, |est − 0.7| < 0.05, each rank's K1 and K2 once a step and
   K3 once a resample (under ``launches_processes``: rank 0's ring run),
   the run and config 5 against the same runs on a one-process mesh of 2
   shards (|Δest| < 1e-4 and 5 combined posterior sd, resample counts
   within ``PROCESS_RESAMPLE_BAR``, the records to rtol 1e-5 before the
   first resample, that resample's inputs equal and its estimates within
   5 standard errors), each rank's K1 at its last step (n = 2²¹) and K3
   on its first fill (1 x 2²¹ rows) held against their plain versions
   (K3 to the bit; their times under ``other_shapes``), and each run's
   wall, rate and collectives' wall printed. Then the rest of the engine
   on the ranks (``qinfer_tpu_torch.parallel.runs``), each leg against
   the same run on the one-process mesh of 2 shards (the same draws and
   the first resample's inputs before it, to the bit and to rtol 1e-5,
   then by law): the resample-move recipe at 50 000 x 255 x 400 steps,
   saved after step 200 and resumed on 2 fresh ranks to the bit, the
   archive loaded into one process equal to the ranks' blocks, each
   fidelity above the prior mean's and the two within
   ``PROCESS_FIDELITY_BAR``, acceptance in [0.09, 0.19], one move call a
   resample, each rank's K3 (1 x 25 000 rows, d = 255) and K5 (25 000,
   32, 32) equal to their plain versions, K6 once a rank; the drift walk
   of ``item8_bench``, its static model under waste-free resample-move
   and ALE, each within ``item8_bench``'s 4 sd; ``perf_test_scan_batch``
   with accelerated precession, 8 x 131 072 x 64, on the trial mesh
   across the ranks, equal to the one-process trial mesh to the bit.
   Then a one-rank NCCL group on the card runs the worker's
   ``collectives`` task: its collectives and engine values equal the
   one-process mesh of one shard's to the bit, timed by CUDA events.
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

``python3 chip_smoke.py --cards 4`` needs four cards of one host (it
exits 1 on fewer, and runs nothing in their place): after phases 1-2 it
runs the process phase's legs over 4 ranks, one a card, by NCCL (and the
resample-move leg's resume on 4 fresh NCCL ranks), by gloo on the same
cards, and on a one-process mesh of 4 shards of card 0, and holds them
to the bars of :func:`run_cards`; then it prints the kernels' line (K1,
K3 and K5 at a rank's shapes, with every rank's launches), every card's
line and the ``ok`` line with the count of cards present.
"""

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
_START = time.perf_counter()
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
#: the parallel phase: particles, steps and shards of the sharded
#: precession runs, their seed, and the scaling legs' shard counts
PARALLEL = (N_MAIN, 256, 8)
PARALLEL_SEED = 5
SCALING_SHARDS = (1, 8)
#: the process phase: ranks of the mesh across processes (on a machine
#: with one card they share it, gloo through host memory), the bar on
#: their resample count against the one-process run of the same shards
#: (the two part after float order changes a PGH pick; the bar is stated
#: in PERF.md), and the ranks' time limit
PROCESSES = 2
PROCESS_RESAMPLE_BAR = 10
PROCESS_TIMEOUT_S = 420
#: the process phase's legs of the rest of the engine, each over the
#: ranks and on a one-process mesh of ``PROCESSES`` shards: the
#: resample-move recipe (particles, steps, the step it is saved after and
#: resumed from), the drift walk, its static model under waste-free
#: resample-move and ALE (particles, steps), and the trials (trials,
#: particles, steps; seed ``PARALLEL_SEED``)
PROCESS_FLAGSHIP = (50_000, 400, 200)
PROCESS_DRIFT = (50_000, 120)
PROCESS_WASTE_FREE = (50_000, 40)
PROCESS_ALE = (50_000, 12)
PROCESS_TRIALS = (8, 131_072, 64)
#: ``--cards``: the ranks, one a card, and the waste-free leg there (its
#: 8 stages run n/8 chains, which the ranks must divide: 50 000 gives
#: 6250, 51 200 gives 6400)
CARDS = 4
CARDS_WASTE_FREE = (51_200, 40)
#: the bar on |fidelity(ranks) − fidelity(one process)| of the
#: resample-move leg: the runs part at the first resample and are then
#: two draws of one law (PERF.md §6 sets it from a CPU rehearsal)
PROCESS_FIDELITY_BAR = 0.05
#: the mean Metropolis acceptance of the resample-move recipe
PROCESS_ACCEPTANCE = (0.09, 0.19)
#: item8_bench's bar: |posterior mean − truth| / sd
PROCESS_Z_BAR = 4.0
#: rows of each Jacobi batch held against host float64
N_F64 = 2000
#: the process path's resample fill: (particles, parameters)
K3_PROCESS = (50_000, 255)
#: the card's peaks (H100 SXM data sheet): device-memory bytes a second,
#: and float32 operations a second outside the tensor cores with each
#: operation rounded on its own (the sheet's 67 TFLOP/s count an FMA as 2)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
#: the card's L2 (H100 SXM: 50 MB)
L2_BYTES = 50 * 2 ** 20
#: each kernel's source and the TPU kernel it replaces
KERNEL_SOURCES = {
    "fused_precession_update": ("qinfer_tpu_torch/csrc/precession.cu",
                                "qinfer_tpu/ops/precession.py:80"),
    "precession_pr0": ("qinfer_tpu_torch/csrc/precession.cu",
                       "qinfer_tpu/ops/precession.py:146"),
    "streaming_resample_locations": (
        "qinfer_tpu_torch/csrc/streaming_resample.cu",
        "qinfer_tpu/ops/streaming_resample.py:181"),
    "jacobi_project_lanes": ("qinfer_tpu_torch/csrc/jacobi.cu",
                             "qinfer_tpu/ops/jacobi.py:309"),
    "jacobi_project_lanes_looped": ("qinfer_tpu_torch/csrc/jacobi.cu",
                                    "qinfer_tpu/ops/jacobi.py:230"),
    "jacobi_eigh_lanes": ("qinfer_tpu_torch/csrc/jacobi.cu",
                          "qinfer_tpu/ops/jacobi.py:269"),
    "counting_multiplicities_from_u": (
        "qinfer_tpu_torch/csrc/counting_pass.cu",
        "none (the JAX package's jnp.cumsum and cummax, "
        "qinfer_tpu/resamplers.py:164)"),
}


def kernel_result(name, **keys):
    """The start of a kernel's entry in the kernels' line: its name, route,
    source and the TPU kernel it replaces, then ``keys``."""
    source, replaces = KERNEL_SOURCES[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                **keys)


def bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the least time of a call that must move
    ``nbytes`` of device memory (each input read once, each output written
    once) and do ``ops`` float32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def k3_bytes(m, d):
    """The bytes a K3 call on counts ``m`` at width ``d`` must move: the
    starts read (4 B a row), each row with copies read once (4·d B; the
    kernel never reads a row of count 0, so this run's counts say how
    many are read), the output written (4·d B a row, as many rows as
    counts)."""
    n = m.numel()
    return 4 * n + 4 * d * int((m > 0).sum()) + 4 * d * n


def k3_bound(m, d):
    """Bound of a K3 call (:func:`k3_bytes`; no arithmetic)."""
    return bound(k3_bytes(m, d), 0)


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
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase} {time.perf_counter() - _START:.1f} s] {msg}",
          flush=True)


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


def event_ms(fn, reps=5, warm=True):
    """Time of one ``fn()`` in ms between two CUDA events around ``reps``
    back-to-back calls, after one call to warm up unless ``warm`` is
    false (the caller warmed it). For the Jacobi kernels and their plain
    versions:
    the plain ones launch ~10⁴ kernels a call, and after some 30 such
    profiler sessions in one process the profiler stopped reporting
    device time (two calls on the card). A kernel's single launch or the
    plain version's long device queue keeps the card busy between the
    events, so this is device time up to the first launch's latency."""
    import torch

    if warm:
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


def from_device_memory(call, args, nbytes):
    """``call(*args)`` as a function of no arguments that takes, call
    after call, the next of copies of ``args`` in turn, enough copies that
    the calls between two of one copy move three times the L2
    (``nbytes``: what one call reads and writes). Each call so finds its
    inputs in device memory, as a call on the path does, and not in the
    L2 where the call before left them. Arguments that are not tensors
    are passed as they are."""
    import itertools

    import torch

    sets = [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args)
                     for _ in range(math.ceil(3 * L2_BYTES / nbytes))]
    turn = itertools.cycle(sets)
    return lambda: call(*next(turn))


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
        kernel_result("fused_precession_update", max_abs_err=err),
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
        kernel_result("precession_pr0", max_abs_err=err),
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
        nn, d = x.shape
        return timed(
            result, lambda: sr.streaming_resample_locations(m, s, x),
            lambda: sr.streaming_resample_locations_plain(m, s, x),
            library=lambda: torch.repeat_interleave(x, m, dim=0,
                                                    output_size=nn),
            bound_at=k3_bound(m, d))

    timers.append(fill_timed(
        kernel_result("streaming_resample_locations", max_abs_err=0.0),
        *cases[0]))
    extra.append(fill_timed("streaming_resample_locations n=%d, d=%d"
                            % K3_PROCESS, *cases[3]))
    say("kernels", f"K3 streaming_resample_locations n={n}, d=1: bit-exact "
                   f"(also d=3, n={n - 3}, and raw bit patterns at d=2 and "
                   f"at n, d = {K3_PROCESS})")

    timers_c, extra_c = check_counting_pass(torch, dev, g)
    return timers + timers_c, extra + extra_c


def _float64_ceilings(torch, u, w, n):
    """``ceil(n·F − u)`` per row of the float64 CDF of ``w`` (rows, n),
    the last one n: the counts' exact first slots, on the card."""
    cdf = torch.cumsum(w.double(), dim=-1)
    upper = torch.ceil(n * (cdf / cdf[..., -1:]) - u.double()[..., None])
    upper[..., -1] = n
    return upper


def check_counting_pass(torch, dev, g):
    """The counting pass (``ops.counting_pass``, three kernels a call)
    against its plain version at the shapes its callers give it: one row
    of 2²² (precession), of 50 000 (the process paths) and 12 rows of
    131 072 (the batched trials' resample). On integer weights, which
    every order sums exactly, to the bit; on random weights Σ m = n in
    each row, the same bits on a second call, and every ceiling within
    one slot of the float64 count (the plain version's distance printed
    beside it). Returns ``(timers, extra)`` as :func:`check_kernels`; the
    bound: the weights read once, counts and offsets written once (12 B a
    particle), ~10 operations a particle."""
    from qinfer_tpu_torch.ops import counting_pass as cp

    name = "counting_multiplicities_from_u"
    no_library = ("no one PyTorch call counts copies from a CDF (the plain "
                  "version: cumsum, ceilings, cummax)")
    cases = []
    for shape in ((N_MAIN,), (K3_PROCESS[0],), (12, TRIALS[1])):
        n = shape[-1]
        u = torch.rand(shape[:-1], generator=g, device=dev)
        w = torch.randint(0, 4, shape, generator=g, device=dev).float()
        w[..., -1] = 1.0
        got = cp.counting_multiplicities_from_u(u, w, n)
        want = cp.counting_multiplicities_from_u_plain(u, w, n)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"counting pass differs from plain on integer weights at "
                f"{shape}")
        w = torch.rand(shape, generator=g, device=dev) ** 8 + 1e-12
        w = w / w.sum(dim=-1, keepdim=True)
        m, off = cp.counting_multiplicities_from_u(u, w, n)
        again = cp.counting_multiplicities_from_u(u, w, n)
        require(torch.equal(m, again[0]) and torch.equal(off, again[1]),
                f"counting pass not deterministic at {shape}")
        require(bool((m.reshape(-1, n).sum(dim=1) == n).all())
                and int(m.min()) >= 0, f"counting pass: Σ m != n at {shape}")
        exact = _float64_ceilings(torch, u, w.reshape(-1, n), n)
        p_m, p_off = cp.counting_multiplicities_from_u_plain(u, w, n)
        off_by = [int(((o + mm).reshape(-1, n) - exact).abs().max())
                  for mm, o in ((m, off), (p_m, p_off))]
        require(off_by[0] <= 1, f"counting pass: a ceiling {off_by[0]} "
                                f"slots from the float64 count at {shape}")
        cases.append((shape, u, w, off_by))
    timers, extra = [], []
    for k, (shape, u, w, off_by) in enumerate(cases):
        n = shape[-1]
        label = " x ".join(map(str, shape))
        entry = timed(
            kernel_result(name, slots_from_float64=off_by[0]) if k == 0
            else f"{name} {label}",
            lambda u=u, w=w, n=n: cp.counting_multiplicities_from_u(u, w, n),
            lambda u=u, w=w, n=n: cp.counting_multiplicities_from_u_plain(
                u, w, n),
            no_library=no_library, bound_at=bound(12 * w.numel(),
                                                  10 * w.numel()),
            attach=None if k == 0 else dict(kernel=name))
        (timers if k == 0 else extra).append(entry)
    say("kernels", "counting pass, ceilings' slots from the float64 count "
                   "(chain / plain): " + ", ".join(
                       f"{' x '.join(map(str, c[0]))}: {c[3][0]} / {c[3][1]}"
                       for c in cases) +
        "; equal to plain to the bit on integer weights, deterministic, "
        "Σ m = n")
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
    # (kernel, its plain version, shapes checked, the main path's shape:
    # the diffusive path's d = 8, the process path's 32)
    for name, fn, plain, dims, main_d in (
            ("jacobi_project_lanes", jac.jacobi_project_lanes,
             jac.jacobi_project_lanes_plain, (8, 16), 8),
            ("jacobi_project_lanes_looped", jac.jacobi_project_lanes_looped,
             jac.jacobi_project_lanes_looped_plain, (32,), 32)):
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
            kernel_result(name, max_abs_err=err),
            lambda fn=fn, a=a, s=sweeps: fn(a, sweeps=s),
            lambda plain=plain, a=a, s=sweeps: plain(a, sweeps=s),
            no_library=no_projection,
            bound_at=jacobi_bound(a.shape[0], main_d, sweeps, True)))
    a16, s16 = inputs[16][0]
    # the flagship leg on 8 shards (scaling_bench): 8 x 8192 two-qubit
    # states, one projection a move call
    a, sweeps = inputs[8][0]
    a = a[:65_536].contiguous()
    extra.append(timed(
        "jacobi_project_lanes (65536, 8, 8) (the flagship leg, 8 shards)",
        lambda a=a, s=sweeps: jac.jacobi_project_lanes(a, sweeps=s),
        lambda a=a, s=sweeps: jac.jacobi_project_lanes_plain(a, sweeps=s),
        no_library=no_projection,
        bound_at=jacobi_bound(a.shape[0], 8, sweeps, True)))
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
        kernel_result("jacobi_eigh_lanes", max_abs_err=err),
        lambda: jac.jacobi_eigh_lanes(a8, sweeps=EMBEDDED_SWEEPS),
        lambda: jac.jacobi_eigh_lanes_plain(a8, sweeps=EMBEDDED_SWEEPS),
        **eigh_library(torch, a8),
        bound_at=jacobi_bound(a8.shape[0], 8, EMBEDDED_SWEEPS, False)))
    extra.append(timed(
        "jacobi_eigh_lanes (50000, 16, 16)",
        lambda: jac.jacobi_eigh_lanes(a16, sweeps=s16),
        lambda: jac.jacobi_eigh_lanes_plain(a16, sweeps=s16),
        **eigh_library(torch, a16),
        bound_at=jacobi_bound(a16.shape[0], 16, s16, False)))
    wide_projection(torch, dev, g)
    return timers, extra


#: the projection past the Jacobi kernels' gate, timed once: (matrices,
#: embedded d) of a 5-qubit state model's resample (no TPU kernel covers
#: it; the model warns with PerformanceWarning)
WIDE = (50_000, 64)


def wide_projection(torch, dev, g):
    """``project_psd_embedded`` past d = 32, where it takes
    ``torch.linalg.eigh`` (cuSOLVER) and rebuilds outside: its answer
    against host float64 on a few rows, and its time by CUDA events on
    ``WIDE`` random symmetric matrices, one call after a call on 1000 (the
    full batch is skipped, and the rate of the small one printed, when the
    small one shows it would pass 60 s); or cuSOLVER's refusal."""
    import numpy as np
    from qinfer_tpu_torch.tomography.models import project_psd_embedded

    n, d = WIDE
    a = _random_symmetric(torch, dev, n, d, g)
    try:
        t0 = time.perf_counter()
        got = project_psd_embedded(a[:1000])
        torch.cuda.synchronize()
        small = time.perf_counter() - t0
    except RuntimeError as exc:
        cusolver_refusal(exc, a[:1000])
        return
    ref, _ = _f64_projection(np, a[:20].cpu().numpy())
    err = float(np.abs(got[:20].cpu().numpy() - ref).max())
    require(err <= 1e-4, f"project_psd_embedded d={d}: {err} from float64")
    if small * n / 1000 > 60:
        say("kernels", f"project_psd_embedded (1000, {d}, {d}) (d > 32: "
                       f"torch.linalg.eigh): {small * 1e3:.1f} ms wall, "
                       f"{small:.3g} ms a matrix; the full {n} skipped; "
                       f"|· - f64| {err:.3g}")
        return
    try:
        # cuSOLVER is warm from the small call; one full call is ~40 s
        ms = event_ms(lambda: project_psd_embedded(a), reps=1, warm=False)
    except RuntimeError as exc:
        cusolver_refusal(exc, a)
        return
    say("kernels", f"project_psd_embedded {tuple(a.shape)} (d > 32: "
                   f"torch.linalg.eigh and the rebuild): {ms:.4f} ms by CUDA "
                   f"events, one call; |· - f64| {err:.3g} on 20 rows")


def cusolver_refusal(exc, a):
    """Print cuSOLVER's refusal of ``project_psd_embedded``'s batch ``a``
    (``CUSOLVER_STATUS_INVALID_VALUE``, the one status that means it);
    re-raise any other error."""
    if "CUSOLVER_STATUS_INVALID_VALUE" not in str(exc):
        raise exc
    say("kernels", f"project_psd_embedded {tuple(a.shape)}: "
                   f"torch.linalg.eigh refuses the batch: "
                   f"{str(exc).strip().splitlines()[0]}")


def eigh_library(torch, a):
    """K6's library call, ``torch.linalg.eigh`` on the same batch, if
    cuSOLVER takes it; else the refusal (``CUSOLVER_STATUS_INVALID_VALUE``:
    any other error is raised), and the time of the largest batch (halving
    from ``a``'s) that it takes."""
    def call(b):
        return lambda: torch.linalg.eigh(b)

    try:
        call(a)()
        torch.cuda.synchronize()
        return dict(library=call(a))
    except RuntimeError as exc:
        if "CUSOLVER_STATUS_INVALID_VALUE" not in str(exc):
            raise
        refusal = str(exc).strip().splitlines()[0]
    b = a[:a.shape[0] // 2]
    while b.shape[0] >= 1:
        try:
            call(b)()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            if "CUSOLVER_STATUS_INVALID_VALUE" not in str(exc):
                raise
            b = b[:b.shape[0] // 2]
            continue
        say("kernels", f"torch.linalg.eigh takes {b.shape[0]} of the "
                       f"{a.shape[0]} {tuple(a.shape[1:])} matrices: "
                       f"{event_ms(call(b)):.4f} ms by CUDA events")
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

    from qinfer_tpu_torch.ops.counting_pass import (
        counting_multiplicities_from_u as counting)

    counted = counted_wrappers()
    bench.timed_run(N_MAIN, bench.N_STEPS, 0, dev)  # warm-up
    walls, launches = [], {}
    for rep in range(bench.N_REPEATS):
        for fn in counted.values():
            fn.launches = 0
        counting.launches = 0
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
        require(counting.launches == updater.resample_count,
                f"the counting pass ran {counting.launches} times for "
                f"{updater.resample_count} resamples")
        launches["counting_multiplicities_from_u"] = counting.launches
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
    recorded resample's shape, and the unchunked run's final state and
    posterior mean."""
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
        finals[chunk] = (r["state"], rs.first, est)

    state, recorded, mean0 = finals[0]
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
    entry = timed(
        f"streaming_resample_locations n={n}, d=1 (config 5's first "
        f"resample)",
        lambda: sr.streaming_resample_locations(m, starts, x),
        lambda: sr.streaming_resample_locations_plain(m, starts, x),
        library=lambda: torch.repeat_interleave(x, m, dim=0, output_size=n),
        bound_at=k3_bound(m, 1))
    return entry, state, mean0


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
            bound_at=k3_bound(m, d),
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
                    bound_at=k3_bound(m, d),
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


def _replay_batch_fill(torch, dev, u, w, x, what):
    """A recorded batched fill replayed from its inputs (``u`` (T',), ``w``
    (T', n), ``x`` (T', n, d): the offsets drawn again from the generator
    state the resample met): the one K3 launch over the flat rows against
    the plain twin, and against each row block's own K3 launch, to the
    bit. Each row's counts sum to n; the counts of a 1-D call on the same
    offset and weights are compared too (a 1-D cumsum on the card is
    another summation order, so a span boundary may move by one slot) and
    the moved slots printed. Returns ``(m, starts, flat rows, T')``."""
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.resamplers import (counting_locations_batch_from_u,
                                             counting_multiplicities_from_u)

    tp, n, d = x.shape
    x_anc, m, starts = counting_locations_batch_from_u(u, w, x)
    flat = x.reshape(tp * n, d)
    require(torch.equal(m.reshape(tp, n).sum(dim=1),
                        torch.full((tp,), n, device=dev)),
            f"{what}: a row's counts do not sum to n")
    plain = sr.streaming_resample_locations_plain(m, starts, flat)
    require(torch.equal(plain.view(torch.int32),
                        x_anc.reshape(tp * n, d).view(torch.int32)),
            f"{what}: the batched K3 fill differs from the plain twin")
    moved, shift = 0, 0
    for t in range(tp):
        rows = slice(t * n, (t + 1) * n)
        alone = sr.streaming_resample_locations(
            m[rows].contiguous(), (starts[rows] - t * n).contiguous(),
            x[t].contiguous())
        require(torch.equal(alone.view(torch.int32),
                            x_anc[t].view(torch.int32)),
                f"{what}: block {t}'s own K3 fill differs from its rows of "
                "the batched fill")
        m1, s1 = counting_multiplicities_from_u(u[t], w[t], n)
        moved += int((m1 != m[rows]).sum())
        shift = max(shift, int((s1 - (starts[rows] - t * n)).abs().max()))
    say("main", f"{what}: a batched K3 call over {tp} x {n} rows "
                f"replayed: equal to the plain twin and to each block's own "
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
    from qinfer_tpu_torch import (ParticleMesh, SimplePrecessionModel,
                                  UniformDistribution)
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
        mesh = (ParticleMesh([dev], axis_name="trials")
                if label == "sequential" else None)
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
    gen_state, w, x = recorded
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    u = torch.rand((x.shape[0],), generator=g, device=dev)
    m, starts, flat, tp = _replay_batch_fill(torch, dev, u, w, x, "trials")

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
        bound_at=k3_bound(m, 1),
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


def _recording_distributed(mesh, exchange):
    """A ``DistributedLiuWestResampler(a=0.98)`` on ``mesh`` that counts
    its calls and keeps the inputs of its first one: the generator's
    state, the weights and the particles."""
    from qinfer_tpu_torch.parallel import DistributedLiuWestResampler

    class Recording(DistributedLiuWestResampler):
        calls = 0
        first = None

        def call_with_diagnostics(self, model, generator, w, x):
            self.calls += 1
            if self.first is None:
                self.first = (generator.get_state(), w.clone(), x.clone())
            return super().call_with_diagnostics(model, generator, w, x)

    return Recording(mesh, a=0.98, exchange=exchange)


def _resample_ms(torch, rs, model, w, x, reps=5):
    """Wall time of one resample call in ms, each call synchronized (the
    resampler waits for the card itself: its Cholesky verdict and
    validity rounds), after one warm-up call."""
    g = torch.Generator(device=w.device)
    g.manual_seed(0)
    rs.call_with_diagnostics(model, g, w, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        rs.call_with_diagnostics(model, g, w, x)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def run_parallel_path(torch, dev, card, config5_state, config5_mean):
    """Phase 5: the particle mesh, 8 shards on the card
    (``ParticleMesh([dev] * 8)``), with every launch count set to 0 just
    before each run and read just after.

    (a) ``perf_test_scan`` with the main path's model
    (``AcceleratedPrecessionModel``) at ``PARALLEL`` (2²² particles x 256
    steps, truth ω = 0.7, seed ``PARALLEL_SEED``) sharded over the mesh,
    with ``DistributedLiuWestResampler`` by the ring and then by the
    butterfly: |est − 0.7| < 0.05, the two final states equal to the bit,
    K1 and K2 once a step, K3 once a resample, no Jacobi kernel; beside
    them, one resample of the recorded ensemble by the plain Liu-West and
    by both exchanges, timed. (b) The ring run's first resample replayed:
    its block exchange delivers each ancestor block whole, and its one K3
    launch over the 8 shards' rows equals the plain twin and each shard's
    own K3 fill to the bit. (c) BASELINE config 5 (``expdesign_bench``
    at ``CONFIG5``, unchunked) sharded over the mesh: its final state and
    posterior mean equal the unsharded run's (``config5_state``,
    ``config5_mean``) to the bit, K3 once a resample. (d) The scaling
    legs (``scaling_bench``) at ``SCALING_SHARDS``, seed 0: precession at
    262 144 particles a shard x 32 steps (|est − 0.7| < 0.05) and the
    flagship recipe at 8192 a shard x 150 steps, fidelity at least 0.90;
    K3 once a resample in each run. Returns ``(launches of run (a) by
    kernel, launches of the flagship at the largest D, K3's timing entry
    at the replayed fill)``."""
    from qinfer_tpu_torch import (AcceleratedPrecessionModel, ParticleMesh,
                                  UniformDistribution)
    from qinfer_tpu_torch import expdesign_bench as eb
    from qinfer_tpu_torch import scaling_bench as sb
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.parallel import DistributedLiuWestResampler
    from qinfer_tpu_torch.parallel.resample import (
        exchange_blocks, shard_systematic_ancestors)
    from qinfer_tpu_torch.perf_testing import perf_test_scan
    from qinfer_tpu_torch.resamplers import LiuWestResampler

    counted = counted_wrappers()
    t_phase = time.perf_counter()
    n, steps, shards = PARALLEL
    mesh = ParticleMesh([dev] * shards)
    prior = UniformDistribution([[0.0, 1.0]])

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    # (a) sharded precession, ring then butterfly, one seed
    perf_test_scan(AcceleratedPrecessionModel(), n, prior, 8,
                   true_mps=[[0.7]], seed=PARALLEL_SEED,
                   resampler=DistributedLiuWestResampler(mesh),
                   sharding=mesh.particle_sharding)  # warm-up
    finals, recorders, launches = {}, {}, None
    for exchange in ("ring", "butterfly"):
        rs = _recording_distributed(mesh, exchange)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, rec = perf_test_scan(AcceleratedPrecessionModel(), n, prior,
                                steps, true_mps=[[0.7]], seed=PARALLEL_SEED,
                                resampler=rs,
                                sharding=mesh.particle_sharding)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        est = float(u.est_mean()[0])
        require(abs(est - 0.7) < 0.05,
                f"parallel {exchange}: est {est}, not within 0.05 of 0.7")
        require(bool(torch.isfinite(u.particle_weights).all())
                and bool(torch.isfinite(u.particle_locations).all()),
                f"parallel {exchange}: NaN or inf in the final state")
        require(got["fused_precession_update"] == steps
                and got["precession_pr0"] == steps,
                f"parallel {exchange}: K1/K2 launched "
                f"{got['fused_precession_update']}/{got['precession_pr0']} "
                f"times in {steps} steps")
        require(got["streaming_resample_locations"] == u.resample_count
                == rs.calls >= 1,
                f"parallel {exchange}: K3 launched "
                f"{got['streaming_resample_locations']} times for "
                f"{u.resample_count} resamples")
        require(all(v == 0 for k, v in got.items() if k.startswith("jacobi")),
                f"parallel {exchange}: a Jacobi kernel ran: {got}")
        require(u.sharding == mesh.particle_sharding,
                f"parallel {exchange}: the updater lost its sharding")
        finals[exchange], recorders[exchange] = u.state, rs
        if launches is None:
            launches = got
        say("main", f"parallel {exchange}: {wall:.4f} s for {n} particles x "
                    f"{steps} steps on {shards} shards = "
                    f"{n * steps / wall:.6g} particle-updates/s, est "
                    f"{est:.6f}, {u.resample_count} resamples, launches "
                    f"{got} on {card}")
    a, b = finals["ring"], finals["butterfly"]
    require(all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "weights", "locations", "log_total_likelihood", "min_n_ess")),
        "parallel: the ring and butterfly runs differ")
    gen_state, w, x = recorders["ring"].first
    times = {name: _resample_ms(torch, rs, AcceleratedPrecessionModel(), w,
                                x)
             for name, rs in (
                 ("plain Liu-West", LiuWestResampler(a=0.98)),
                 ("ring", DistributedLiuWestResampler(mesh,
                                                      exchange="ring")),
                 ("butterfly", DistributedLiuWestResampler(
                     mesh, exchange="butterfly")))}
    say("main", "parallel: ring and butterfly final states equal to the "
                "bit; one resample of the first recorded ensemble (n = "
                f"{n}), synchronized walls: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in times.items())
        + f" on {card}")

    # (b) the ring run's first two-level fill, replayed
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    rs = recorders["ring"]
    u1, u2, wv, xv, _ = rs.fill_inputs(g, w, x)
    recv_w, recv_x = exchange_blocks(mesh, u1, wv, xv, "ring")
    anc = shard_systematic_ancestors(u1, wv.sum(dim=1))
    require(torch.equal(recv_x, xv[anc]) and torch.equal(recv_w, wv[anc]),
            "parallel: the ring exchange did not deliver each shard its "
            "ancestor's block")
    m, starts, flat, _ = _replay_batch_fill(torch, dev, u2, recv_w, recv_x,
                                            "parallel")
    say("main", f"parallel: the first resample's ancestor shards "
                f"{anc.tolist()} (u1 = {float(u1):.6f})")

    # (c) BASELINE config 5 on the mesh
    cn, csteps, ccand = CONFIG5
    reset()
    r = eb.run_bench(cn, csteps, ccand, 0, dev,
                     mesh=ParticleMesh([dev] * shards))
    got = read()
    require(r["posterior_mean"] == config5_mean
            and torch.equal(r["state"].locations, config5_state.locations)
            and torch.equal(r["state"].weights, config5_state.weights),
            f"parallel config 5: posterior mean {r['posterior_mean']} on "
            f"{shards} shards, {config5_mean} unsharded: not the same bits")
    # the warm-up run and the timed run are the same run
    require(got["streaming_resample_locations"] == 2 * r["resamples"] >= 2
            and all(v == 0 for k, v in got.items()
                    if k != "streaming_resample_locations"),
            f"parallel config 5: launches {got} for {r['resamples']} "
            f"resamples of each of its two runs")
    say("main", f"parallel config 5 --virtual {shards}: {r['wall_s']:.4f} s "
                f"for {r['particles']} particles x {csteps} steps x {ccand} "
                f"candidates = {r['particle_updates_per_s']:.6g} "
                f"particle-updates/s, posterior mean {r['posterior_mean']:.6f}"
                f" equal to the unsharded run's to the bit, "
                f"{r['resamples']} resamples, launches over warm-up and timed "
                f"run {got} on {card}")

    # (d) the scaling legs, one seed
    legs = ((sb.PrecessionLeg(dev), 262_144, 32),
            (sb.FlagshipLeg(dev), 8192, 150))
    flagship = None
    for leg, per, lsteps in legs:
        sb.one_run(leg, ParticleMesh([dev]), per, sb.WARMUP_STEPS, 0)
        base = None
        for d in SCALING_SHARDS:
            reset()
            run = sb.one_run(leg, ParticleMesh([dev] * d), per * d, lsteps, 0)
            got = read()
            require(run["ok"] and abs(run.get("est", 0.7) - 0.7) < 0.05,
                    f"scaling {leg.name} D={d}: {run}")
            require(got["streaming_resample_locations"] == run["resamples"],
                    f"scaling {leg.name} D={d}: K3 launched "
                    f"{got['streaming_resample_locations']} times for "
                    f"{run['resamples']} resamples")
            base = base or run["updates_per_s"]
            score = (f"fidelity {run['fidelity']:.6f}" if "fidelity" in run
                     else f"est {run['est']:.6f}")
            say("main", f"scaling {leg.name} D={d}: {run['wall_s']:.4f} s "
                        f"for {run['particles']} particles x {lsteps} steps "
                        f"= {run['updates_per_s']:.6g} particle-updates/s "
                        f"(efficiency {run['updates_per_s'] / (d * base):.4f}"
                        f"), {score}, {run['resamples']} resamples, "
                        f"launches {got} on {card}")
            if leg.name == "flagship":
                flagship = got
    say("main", f"parallel phase: {time.perf_counter() - t_phase:.1f} s "
                "with its set-up")
    rows = flat.shape[0]
    entry = timed(
        f"streaming_resample_locations n={rows}, d=1 (parallel: the "
        f"two-level fill, one launch over {shards} shards x "
        f"{rows // shards} rows)",
        lambda: sr.streaming_resample_locations(m, starts, flat),
        lambda: sr.streaming_resample_locations_plain(m, starts, flat),
        library=lambda: torch.repeat_interleave(flat, m, dim=0,
                                                output_size=rows),
        bound_at=k3_bound(m, 1),
        attach=dict(kernel="streaming_resample_locations",
                    launches=launches["streaming_resample_locations"]))
    return launches, flagship, entry


def _run_ranks(torch, world, backend, tasks, *args):
    """Start ``world`` ranks of ``qinfer_tpu_torch.parallel.worker`` on
    the cards (rank r on card r mod the cards present; ``backend`` over a
    ``file://`` store in a fresh temporary directory) and wait for them:
    each rank's RESULT lines, by task. A rank that exits non-zero,
    outlives ``PROCESS_TIMEOUT_S`` or prints no RESULT fails the phase;
    every rank is stopped before this returns."""
    import subprocess
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "qinfer_tpu_torch.parallel.worker",
               "--world", str(world), "--backend", backend,
               "--init-method", f"file://{tmp}/store", "--tasks", tasks,
               *map(str, args)]
        # each rank writes to a file: a rank blocked on a full pipe would
        # stall the others at their next collective
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT,
                                  env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        deadline = time.perf_counter() + PROCESS_TIMEOUT_S
        try:
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    raise SmokeFailure(f"processes ({backend}): a rank "
                                       f"outlived {PROCESS_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
                 if ln.startswith("RESULT ")]
        require(p.returncode == 0 and lines,
                f"processes ({backend}): rank {r} exited {p.returncode} "
                f"with {len(lines)} RESULT lines:\n{out[-4000:]}")
        by_task = {}
        for line in lines:
            by_task.setdefault(line["task"], []).append(line)
        results.append(by_task)
    return results


def _replicated(line):
    """The numbers of a worker's RESULT line that every rank must hold to
    the bit (not its rank, its device, its walls and its own blocks)."""
    return {k: v for k, v in line.items()
            if k not in ("rank", "device", "wall_s", "updates_per_s",
                         "particle_updates_per_s", "candidate_scores_per_s",
                         "peak_memory_bytes")
            and not k.startswith("local")}


def _leg_specs(world):
    """The worker's ``--runs`` of the process phase's legs on ``world``
    ranks (waste-free runs n/8 chains, world | n/8)."""
    n, steps, save_at = PROCESS_FLAGSHIP
    waste_free = (CARDS_WASTE_FREE if world == CARDS
                  else PROCESS_WASTE_FREE)
    return [("flagship", n, steps, save_at),
            ("drift",) + PROCESS_DRIFT + (None,),
            ("drift_waste_free",) + waste_free + (None,),
            ("ale",) + PROCESS_ALE + (None,)]


def _runs_arg(specs):
    return ",".join(":".join(str(v) for v in spec if v is not None)
                    for spec in specs)


def _one_process_legs(torch, dev, world):
    """The legs on a one-process mesh of ``world`` shards of the card:
    each run's record (``qinfer_tpu_torch.parallel.runs.drive``) by name,
    and the trials' digests on the one-process trial mesh."""
    from qinfer_tpu_torch import (AcceleratedPrecessionModel,
                                  UniformDistribution)
    from qinfer_tpu_torch.parallel import ParticleMesh, runs
    from qinfer_tpu_torch.parallel.worker import trial_digests
    from qinfer_tpu_torch.perf_testing import perf_test_scan_batch

    mesh = ParticleMesh([dev] * world)
    out = {}
    for name, n, steps, _ in _leg_specs(world):
        t0 = time.perf_counter()
        out[name] = runs.drive(mesh, runs.make_run(mesh, name, n, steps),
                               steps)
        torch.cuda.synchronize()
        out[name]["wall_s"] = time.perf_counter() - t0
        out[name]["local_run_s"] = (out[name]["wall_s"]
                                    - out[name]["local_record_s"])
    trials, n, steps = PROCESS_TRIALS
    runner, seeds = perf_test_scan_batch(
        AcceleratedPrecessionModel(), n, UniformDistribution([[0.0, 1.0]]),
        steps, trials, seed=PARALLEL_SEED,
        mesh=ParticleMesh([dev] * world, axis_name="trials"),
        return_runner=True, device=dev)
    record = runner(seeds)
    out["trials"] = {"digests": trial_digests(record),
                     "resample_counts": runner.resample_counts}
    return out


def _loaded_checksums(torch, dev, path, world):
    """The resample-move leg's checkpoint (saved by ``world`` ranks)
    loaded into one process, on a one-process mesh of 2 · ``world``
    shards: the checksums of its weights and locations over ``world``
    blocks."""
    from qinfer_tpu_torch.checkpoint import load_updater
    from qinfer_tpu_torch.parallel import ParticleMesh, runs

    n, _, save_at = PROCESS_FLAGSHIP
    run = runs.make_run(ParticleMesh([dev] * (2 * world)), "flagship",
                        n, 0, seed=runs.SEED + 2)
    load_updater(path, run.updater)
    u = run.updater
    require(u.n_particles == n and len(u.normalization_record) == save_at,
            f"processes flagship: the archive loaded into one process "
            f"holds {u.n_particles} particles and "
            f"{len(u.normalization_record)} steps")
    blocks = ParticleMesh([dev] * world)
    return [runs.checksums(blocks, u.particle_weights).tolist(),
            runs.checksums(blocks, u.particle_locations).tolist()]


def _held_alike(name, ranks, one):
    """The steps a leg's two layouts share (the same designs, before the
    first resample): the same generator states and particles to the bit,
    the same first resample, and the normalizations and estimates to rtol
    1e-5. Returns ``(first resample, steps alike, the largest relative
    difference)``."""
    from qinfer_tpu_torch.parallel import runs

    a = ranks[0]
    alike = runs.alike_steps(a, one)
    first = runs.first_resample(one)
    upto = alike if first is None else min(alike, first + 1)
    require(upto == alike or runs.first_resample(a) == first,
            f"processes {name}: the first resample comes at step "
            f"{runs.first_resample(a)} on the ranks and {first} in one "
            f"process")
    require(a["generator"][:upto] == one["generator"][:upto]
            and all(line["local_x"][0][:upto] == one["local_x"][r][:upto]
                    for r, line in enumerate(ranks)),
            f"processes {name}: the generator or the particles differ from "
            f"the one-process run's before step {upto}")
    rel = max(runs.rel_diff(a["norm"][:upto], one["norm"][:upto]),
              runs.rel_diff(a["est"][:max(upto - 1, 0)],
                            one["est"][:max(upto - 1, 0)]))
    require(rel <= 1e-5, f"processes {name}: the steps before the first "
                         f"resample part by rtol {rel}")
    return first, alike, rel


def _walls(a, o):
    """A leg's walls on rank 0 (``a``) and in one process (``o``): the
    run's own, then the record's reads (:func:`qinfer_tpu_torch.parallel.
    runs.drive`), each with its collectives."""
    return (f"the run {a['local_run_s']:.4f} s on the ranks "
            f"({a['run_collective_calls']} collectives a rank taking "
            f"{a['local_run_collective_s']:.4f} s by "
            f"{a['collective_timer']}), {o['local_run_s']:.4f} s "
            f"in one process; the record's reads besides "
            f"{a['local_record_s']:.4f} s on the ranks "
            f"({a['record_collective_calls']} collectives taking "
            f"{a['local_record_collective_s']:.4f} s), "
            f"{o['local_record_s']:.4f} s in one process")


def _check_process_legs(torch, dev, card, world, results, resumed, one, kept,
                        loaded):
    """Phase 5's legs of the rest of the engine on the ranks, against
    ``one`` (:func:`_one_process_legs`): (d) the resample-move recipe
    (``PROCESS_FLAGSHIP``), resumed from its checkpoint on fresh ranks
    (``resumed``) to the bit, its archive loaded into one process
    (``loaded``, :func:`_loaded_checksums`) equal to the ranks' blocks,
    the steps before its first resample alike (:func:`_held_alike`), then
    by law (fidelities, acceptance, one move call a resample), each
    rank's K3 and K5 on its ``kept`` inputs against the plain versions;
    (e) the drift walk, its waste-free static model and ALE, alike while
    their PGH designs agree and before the first resample, then within
    ``item8_bench``'s bar; (f) the trials equal to the one-process trial
    mesh to the bit, with each rank's launches. Returns ``(launches on rank 0's
    resample-move run, launches on rank 0's trials, timing entries of K3
    and K5 at rank 0's shapes)``."""
    from qinfer_tpu_torch import tomography_bench as tb
    from qinfer_tpu_torch.config import EPS
    from qinfer_tpu_torch.ops import jacobi as jac
    from qinfer_tpu_torch.ops import streaming_resample as sr
    from qinfer_tpu_torch.parallel import runs
    from qinfer_tpu_torch.tomography.bases import EMBEDDED_SWEEPS

    legs = [{line["run"]: line for line in res.get("runs", [])}
            for res in results]
    back = [{line["run"]: line for line in res.get("runs", [])}
            for res in resumed]
    for name, *_ in _leg_specs(world):
        lines = [leg.get(name) for leg in legs]
        require(all(lines) and all(_replicated(a) == _replicated(lines[0])
                                   for a in lines),
                f"processes {name}: the ranks' replicated results differ")
    trials = [res.get("trials", [None])[0] for res in results]
    require(all(trials) and all(_replicated(t) == _replicated(trials[0])
                                for t in trials),
            "processes trials: the ranks' replicated results differ")

    # (d) the resample-move recipe
    n, steps, save_at = PROCESS_FLAGSHIP
    ranks = [leg["flagship"] for leg in legs]
    a, o = ranks[0], one["flagship"]
    first, _, rel = _held_alike("flagship", ranks, o)
    require(first is not None, "processes flagship: no resample")
    for r in range(world):
        x, y = ranks[r], back[r].get("flagship", {})
        same = (y.get("resumed")
                and [y["local_w"][0][0], y["local_x"][0][0]]
                == [x["local_at_save"][0][0], x["local_at_save"][1][0]]
                and all(y[k][0] == x[k][0][save_at:]
                        for k in ("local_w", "local_x"))
                and all(y[k] == x[k][save_at:]
                        for k in ("norm", "est", "resamples", "generator"))
                and all(y[k] == x[k] for k in ("local_final", "final_est",
                                               "resample_count",
                                               "log_scale")))
        require(same, f"processes flagship rank {r}: the run resumed from "
                      f"step {save_at} on fresh ranks differs from the "
                      f"uninterrupted one")
    require(loaded == [[ranks[r]["local_at_save"][i][0]
                        for r in range(world)] for i in range(2)],
            "processes flagship: the archive loaded into one process differs "
            "from the ranks' blocks")
    for rec, where in ((a, "ranks"), (o, "one process")):
        acc = sum(rec["acceptance"]) / max(len(rec["acceptance"]), 1)
        require(rec["fidelity"] > rec["prior_fidelity"]
                and PROCESS_ACCEPTANCE[0] <= acc <= PROCESS_ACCEPTANCE[1]
                and len(rec["acceptance"]) == rec["resample_count"] >= 1,
                f"processes flagship ({where}): fidelity {rec['fidelity']} "
                f"(prior mean's {rec['prior_fidelity']}), acceptance {acc}, "
                f"{len(rec['acceptance'])} move calls for "
                f"{rec['resample_count']} resamples")
    d_fid = abs(a["fidelity"] - o["fidelity"])
    require(d_fid < PROCESS_FIDELITY_BAR,
            f"processes flagship: fidelities {a['fidelity']} / "
            f"{o['fidelity']} differ by {d_fid}")
    launches = a["local_launches"]
    for r, rec in enumerate(ranks):
        got = rec["local_launches"]
        require(got["streaming_resample_locations"] == rec["resample_count"]
                and got["jacobi_project_lanes_looped"]
                == rec["local_projections"] >= 1
                and got["jacobi_eigh_lanes"] == 1,
                f"processes flagship rank {r}: launches {got} for "
                f"{rec['resample_count']} resamples and "
                f"{rec['local_projections']} projections")
    say("main", f"processes flagship: {n} particles x {steps} steps, "
                f"{world} ranks against the one-process mesh of "
                f"{world} shards: the first resample at step {first}, "
                f"the steps through it within rtol {rel:.3g} (the generator "
                f"and the particles to the bit); fidelity {a['fidelity']:.6f}"
                f" / {o['fidelity']:.6f} (prior mean "
                f"{a['prior_fidelity']:.6f},"
                f" |Δ| {d_fid:.3g}), acceptance "
                f"{sum(a['acceptance']) / len(a['acceptance']):.4f} / "
                f"{sum(o['acceptance']) / len(o['acceptance']):.4f}, "
                f"resamples {a['resample_count']} / {o['resample_count']}; "
                f"resumed from step {save_at} on fresh ranks equal to the "
                f"bit, the archive loaded into one process equal to the "
                f"ranks' blocks; {_walls(a, o)}; launches a rank "
                f"{launches} on {card}")

    # each rank's K3 and K5 at the recipe's shapes
    cfg = tb.make_config("process", dev, process_qubits=2)
    entries = []
    for r, rank in enumerate(kept):
        u2, recv_w, recv_x, m_rank, starts_rank, x_rank = (
            v.to(dev) for v in rank["fill"])
        rows = recv_x.shape[0] * recv_x.shape[1]
        m, starts, flat, _ = _replay_batch_fill(
            torch, dev, u2, recv_w, recv_x, f"processes flagship rank {r}")
        plain = sr.streaming_resample_locations_plain(m_rank, starts_rank,
                                                      flat)
        require(torch.equal(m, m_rank) and torch.equal(starts, starts_rank)
                and torch.equal(plain.view(torch.int32), x_rank.reshape(
                    rows, -1).view(torch.int32)),
                f"processes flagship rank {r}: the rank's K3 fill differs "
                f"from the plain twin on its counts")
        mats = cfg.model._embedded_states(rank["k5"].to(dev))
        got = jac.jacobi_project_lanes_looped(mats, sweeps=EMBEDDED_SWEEPS,
                                              trace=2.0, eps=EPS)
        want = jac.jacobi_project_lanes_looped_plain(
            mats, sweeps=EMBEDDED_SWEEPS, trace=2.0, eps=EPS)
        torch.cuda.synchronize()
        require(rank["projected"] and torch.equal(got, want),
                f"processes flagship rank {r}: K5 on the rank's first "
                f"strict projection differs from the plain version by "
                f"{float((got - want).abs().max())}")
        say("main", f"processes flagship rank {r}: its first fill's K3 "
                    f"launch over {recv_x.shape[0]} x {recv_x.shape[1]} rows "
                    f"(d = {recv_x.shape[2]}) and K5 on its first strict "
                    f"projection {tuple(mats.shape)} equal to the plain "
                    f"versions to the bit")
        if r == 0:
            d = flat.shape[1]
            fill_bytes = k3_bytes(m, d)
            entries = [
                timed(f"streaming_resample_locations n={rows}, d={d} "
                      f"(processes: rank 0's first fill of the resample-move"
                      f" leg, one launch over its 1 x {rows} rows, its "
                      f"inputs in device memory)",
                      from_device_memory(sr.streaming_resample_locations,
                                         (m, starts, flat), fill_bytes),
                      from_device_memory(
                          sr.streaming_resample_locations_plain,
                          (m, starts, flat), fill_bytes),
                      library=from_device_memory(
                          lambda m, f, k=rows: torch.repeat_interleave(
                              f, m, dim=0, output_size=k),
                          (m, flat), fill_bytes),
                      bound_at=k3_bound(m, d),
                      attach=dict(kernel="streaming_resample_locations",
                                  launches=launches[
                                      "streaming_resample_locations"])),
                timed(f"jacobi_project_lanes_looped {tuple(mats.shape)} "
                      f"(processes: rank 0's first strict projection, its "
                      f"inputs in device memory)",
                      from_device_memory(
                          lambda a: jac.jacobi_project_lanes_looped(
                              a, sweeps=EMBEDDED_SWEEPS, trace=2.0, eps=EPS),
                          (mats,), 8 * mats.numel()),
                      from_device_memory(
                          lambda a: jac.jacobi_project_lanes_looped_plain(
                              a, sweeps=EMBEDDED_SWEEPS, trace=2.0, eps=EPS),
                          (mats,), 8 * mats.numel()),
                      no_library="no one PyTorch call projects onto the PSD "
                                 "cone",
                      bound_at=jacobi_bound(mats.shape[0], 32,
                                            EMBEDDED_SWEEPS, True),
                      attach=dict(kernel="jacobi_project_lanes_looped",
                                  launches=launches[
                                      "jacobi_project_lanes_looped"]))]

    # (e) the drift walk, its waste-free static model, ALE: alike while
    # the PGH designs agree and before the first resample, then by law
    for name in ("drift", "drift_waste_free", "ale"):
        ranks = [leg[name] for leg in legs]
        a, o = ranks[0], one[name]
        first, alike, rel = _held_alike(name, ranks, o)
        sd = runs.combined_sd(a, o)
        d_est = [abs(x - y) for x, y in zip(a["final_est"], o["final_est"])]
        require(max(a["z"]) <= PROCESS_Z_BAR and max(o["z"]) <= PROCESS_Z_BAR
                and all(d < 5 * s for d, s in zip(d_est, sd))
                and a["resample_count"] >= 1 and a["finite"],
                f"processes {name}: |mean - truth| / sd {a['z']} / {o['z']},"
                f" final estimates {a['final_est']} / {o['final_est']} "
                f"({sd} combined sd), {a['resample_count']} resamples")
        if name == "ale":
            upto = alike if first is None else min(alike, first + 1)
            require(a["rounds"][:upto] == o["rounds"][:upto],
                    f"processes ale: the rounds differ before step {upto}")
        say("main", f"processes {name}: {a['particles']} particles x "
                    f"{len(a['norm'])} steps, {world} ranks against the "
                    f"one-process mesh: the designs part at step {alike}, "
                    f"the first resample at step {first}, the steps before "
                    f"both within rtol {rel:.3g}; |mean - truth| / sd "
                    f"{max(a['z']):.3f} / {max(o['z']):.3f}, estimates "
                    f"{a['final_est'][0]:.6f} / {o['final_est'][0]:.6f}, "
                    f"resamples {a['resample_count']} / "
                    f"{o['resample_count']}; {_walls(a, o)}")

    # (f) the trials
    t, o = trials[0], one["trials"]
    count, n_t, steps_t = PROCESS_TRIALS
    require(t["digests"] == o["digests"]
            and t["resample_counts"] == o["resample_counts"],
            "processes trials: the ranks' records differ from the "
            "one-process trial mesh's")
    mine = count // world
    for r, line in enumerate(trials):
        got = line["local_launches"]
        own = sum(line["resample_counts"][r * mine:(r + 1) * mine])
        require(got["fused_precession_update"] == mine * steps_t
                and got["precession_pr0"] == mine * steps_t
                and got["streaming_resample_locations"] == own,
                f"processes trials rank {r}: launches {got} for {mine} "
                f"trials of {steps_t} steps and {own} resamples")
    say("main", f"processes trials: {count} x {n_t} x {steps_t} on "
                f"{world} ranks equal to the one-process trial mesh to "
                f"the bit, {t['wall_s']:.4f} s, {t['collective_calls']} "
                f"collectives; launches on rank 0 "
                f"{trials[0]['local_launches']}")
    return launches, trials[0]["local_launches"], entries


def run_processes_path(torch, dev, card, config5_mean):
    """Phase 5: one ensemble sharded over ``PROCESSES`` ranks of a gloo
    group, each rank a process of ``qinfer_tpu_torch.parallel.worker`` on
    card r mod the cards present (on one card the ranks share it, each
    collective staged through host memory; NCCL refuses two ranks on one
    card), the kernels built already, each rank counting its
    own launches from 0 before each run.
    The runs on the one-process mesh come first (:func:`_one_process`),
    then the ranks' (:func:`_on_ranks`), then the checks
    (:func:`_check_processes`).

    (a) ``perf_test_scan`` with ``AcceleratedPrecessionModel`` at
    ``PARALLEL``'s 2²² particles (2²¹ a rank) x 256 steps, truth 0.7, seed
    ``PARALLEL_SEED``, ``DistributedLiuWestResampler`` by the ring and by
    the butterfly: the ranks' estimates, resample counts and evidence
    equal to the bit, ring = butterfly to the bit, |est − 0.7| < 0.05, K1
    and K2 once a step and K3 once a resample on each rank; against the
    same run on a one-process mesh of ``PROCESSES`` shards on the card,
    |Δest| < 1e-4 and the resample counts within
    ``PROCESS_RESAMPLE_BAR`` (the runs agree until float order changes a
    PGH pick, then are two draws of one law; the distances printed).
    The records of the two runs agree to rtol 1e-5 before the first
    resample, which both make at the same step and meet with the same
    generator state, the same particles and weights within rtol 1e-5; its
    two estimates lie within 5 standard errors of two resamples of that
    ensemble (the counting pass parts the runs there: at 2²² one ulp of a
    running sum near 1 is a quarter of a slot, so an ulp of weight moves
    slots), and the final estimates within 5 combined posterior sd as
    well. Where the designs part first, both t there and the inverse
    CDF's picks replayed from the same generator state
    (:func:`_parted_designs`); either way the one-process resampler
    replayed on the ranks' first resample (:func:`_replayed_first_resample`).
    (b) BASELINE config 5 (``CONFIG5``) over the ranks with the two-level
    resampler: the ranks equal to the bit, |mean − 0.7| < 0.05, K3 once a
    resample; against the same run on the one-process mesh of
    ``PROCESSES`` shards, the posterior mean after each step to rtol 1e-5
    while the designs agree and before the first resample (at the same
    step in both, if the designs agree through it), then the final means
    within 5 combined posterior sd (PGH's inverse CDF over 10⁷ weights
    rounds otherwise in the two layouts, so the designs may part from the
    first step; where they part printed) and the resample counts within
    ``PROCESS_RESAMPLE_BAR``; its distance to the unsharded run's
    ``config5_mean`` (the plain Liu-West's trajectory, not this one's)
    printed. Prints each run's wall, particle-updates/s and the wall of
    the ranks' collectives. (c) The kernels at the ranks' shapes: each
    rank's last K1 call of its ring run (n = 2²¹) against the plain
    version (:func:`hold_k1`), and its first fill, replayed on the rank
    (one K3 launch over 1 x 2²¹ rows), against the plain twin to the bit,
    the rank's output and the parent's replay alike. (d)-(f) The rest of
    the engine on the ranks, in the same launch, and the resample-move
    leg resumed in a second one (:func:`_check_process_legs`).
    Returns ``(each kernel's launches on rank 0's ring run, on its
    resample-move leg and on its trials, timing entries of K1, K3 and K5
    at rank 0's shapes)``."""
    t_phase = time.perf_counter()
    one = _one_process(torch, dev, PROCESSES)
    side = _on_ranks(torch, dev, PROCESSES, "gloo")
    out = _check_processes(torch, dev, card, PROCESSES, one, side,
                           config5_mean)
    say("main", f"processes phase: {time.perf_counter() - t_phase:.1f} s "
                "with its set-up")
    return out


def _one_process(torch, dev, world):
    """The process phase's runs on a one-process mesh of ``world`` shards
    of the card: the precession ring run (its resampler recording its
    first call), config 5 and the legs (:func:`_one_process_legs`)."""
    from qinfer_tpu_torch import ParticleMesh, UniformDistribution
    from qinfer_tpu_torch import expdesign_bench as eb
    from qinfer_tpu_torch.parallel import DistributedLiuWestResampler
    from qinfer_tpu_torch.parallel.worker import recorders
    from qinfer_tpu_torch.perf_testing import perf_test_scan

    n, steps, _ = PARALLEL
    mesh = ParticleMesh([dev] * world)
    model, one_rs = recorders(mesh, steps, "ring")
    u, rec = perf_test_scan(
        model, n, UniformDistribution([[0.0, 1.0]]), steps, true_mps=[[0.7]],
        seed=PARALLEL_SEED, resampler=one_rs, sharding=mesh.particle_sharding,
        heuristic_factory=model.heuristic)
    one = dict(est=float(rec["est"][-1, 0]), resamples=u.resample_count,
               sd=float(u.est_covariance_mtx()[0, 0]) ** 0.5,
               est_record=rec["est"][:, 0].tolist(), ess=rec["ess"].tolist(),
               t_record=torch.cat(model.ts).tolist(), first=one_rs.first,
               designs=model.designs)
    del u, rec, model, one_rs
    cn, csteps, ccand = CONFIG5
    mesh = ParticleMesh([dev] * world)
    one["c5"] = eb.run_bench(
        cn, csteps, ccand, 0, dev,
        resampler=DistributedLiuWestResampler(mesh, a=0.98), mesh=mesh,
        record=True)
    del one["c5"]["state"]
    one["legs"] = _one_process_legs(torch, dev, world)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return one


def _on_ranks(torch, dev, world, backend, resume=True):
    """The process phase's runs on ``world`` ranks of ``backend``
    (:func:`_run_ranks`): the precession runs, config 5, the legs and the
    trials in one launch, each rank writing its kernel inputs; with
    ``resume``, the resample-move leg resumed on fresh ranks from the
    first launch's checkpoint, and that checkpoint loaded into one
    process (:func:`_loaded_checksums`). A dict of ``results``, ``kept``
    and ``kept_legs`` (each rank's recorded inputs), ``resumed`` and
    ``loaded``."""
    import tempfile

    n, steps, _ = PARALLEL
    cn, csteps, ccand = CONFIG5
    side = {}
    with tempfile.TemporaryDirectory() as record:
        side["results"] = _run_ranks(
            torch, world, backend, "card,precession,config5,runs,trials",
            "--particles", n, "--steps", steps, "--seed", PARALLEL_SEED,
            "--config5", f"{cn},{csteps},{ccand}", "--record", record,
            "--runs", _runs_arg(_leg_specs(world)), "--checkpoint", record,
            "--trials", ",".join(map(str, PROCESS_TRIALS)))
        side["kept"] = [torch.load(os.path.join(record, f"rank{r}.pt"))
                        for r in range(world)]
        side["kept_legs"] = [
            torch.load(os.path.join(record, f"flagship_rank{r}.pt"))
            for r in range(world)]
        if resume:
            side["resumed"] = _run_ranks(
                torch, world, backend, "runs", "--runs",
                _runs_arg(_leg_specs(world)[:1]), "--checkpoint", record,
                "--resume")
            side["loaded"] = _loaded_checksums(
                torch, dev, os.path.join(record, "flagship"), world)
    return side


def _held_first_resample(torch, dev, n, kept, one, ring, first):
    """The first resample of the precession ring run, met by the ranks and
    the one process with the same designs: the same generator state and
    particles, the weights up to the reweights' float order (rtol 1e-5);
    its two estimates are then two resamples of one weighted ensemble
    (within 5√2 standard errors)."""
    gen_state = kept[0]["resample"][0]
    w = torch.cat([k["resample"][1] for k in kept]).to(dev)
    x = torch.cat([k["resample"][2] for k in kept]).to(dev)
    one_gen, one_w, one_x = one["first"]
    w_rel = float(((w - one_w).abs() / one_w.abs().clamp_min(1e-30)).max())
    require(all(torch.equal(k["resample"][0], gen_state) for k in kept)
            and torch.equal(gen_state, one_gen.cpu())
            and torch.equal(x, one_x) and w_rel <= 1e-5,
            f"processes: the first resample's inputs differ from the "
            f"one-process run's (weights by rtol {w_rel})")
    mu = float(one_w @ one_x[:, 0])
    se = float(one_w @ (one_x[:, 0] - mu) ** 2) ** 0.5 / math.sqrt(n)
    d_first = abs(ring["est_record"][first] - one["est_record"][first])
    say("main", f"processes: the first resample met the one-process run's "
                f"generator state and particles to the bit and its weights "
                f"within rtol {w_rel:.3g}; resampled, the estimates differ "
                f"by {d_first:.3g} (one resample's standard error "
                f"{se:.3g})")
    require(d_first < 5 * math.sqrt(2) * se,
            f"processes: the first resample's estimates differ by "
            f"{d_first}, more than 5 standard errors of two resamples")


def _counting_cdf(torch, w):
    """The normalized CDF of each row of ``w`` that the counting fill
    counts over (``resamplers.counting_multiplicities_from_u``)."""
    from qinfer_tpu_torch.config import EPS
    from qinfer_tpu_torch.utils import cumsum_last

    cdf = cumsum_last(w)
    return torch.clamp_max(cdf / torch.clamp_min(cdf[..., -1:], EPS), 1.0)


def _replayed_first_resample(torch, dev, world, kept):
    """The ranks' first resample of the precession ring run against the
    one-process resampler on the same inputs: a
    ``DistributedLiuWestResampler`` on a one-process mesh of ``world``
    shards replays the ranks' recorded first call (the generator state,
    weights and particles) through its fill, held against the fill each
    rank recorded. To the bit: the offsets u₂, and the block of
    particles each shard receives (so the same ancestor shards). Within
    float order: the received weights to rtol 1e-5 (one process sums
    ``world`` rows at once, a rank one row), their counting CDFs within
    δ ≤ 1e-5 (one process scans the rows at once, a rank one row:
    ``utils.cumsum_last``), and so every particle's first slot within
    ⌊(n/D)·δ + 1/4⌋ + 1 slots of the rank's (a ceiling of values that
    differ by (n/D)·δ plus the rounding of two float32 products). Returns
    the line that says so."""
    from qinfer_tpu_torch import ParticleMesh
    from qinfer_tpu_torch.parallel import DistributedLiuWestResampler
    from qinfer_tpu_torch.parallel.resample import (
        exchange_blocks, shard_systematic_ancestors)
    from qinfer_tpu_torch.resamplers import counting_locations_batch_from_u

    gen_state = kept[0]["resample"][0]
    require(all(torch.equal(k["resample"][0], gen_state) for k in kept),
            "processes: the ranks' first resamples start from different "
            "generator states")
    w = torch.cat([k["resample"][1] for k in kept]).to(dev)
    x = torch.cat([k["resample"][2] for k in kept]).to(dev)
    mesh = ParticleMesh([dev] * world)
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    rs = DistributedLiuWestResampler(mesh, a=0.98, exchange="ring")
    u1, u2, wv, xv, _ = rs.fill_inputs(g, w, x)
    recv_w, recv_x = exchange_blocks(mesh, u1, wv, xv, "ring")
    x_anc, m, starts = counting_locations_batch_from_u(u2, recv_w, recv_x)
    ranks = [[v.to(dev) for v in k["fill"]] for k in kept]
    r_u2, r_w, r_x, r_m, r_starts, r_anc = (
        torch.cat([f[i] for f in ranks]) for i in range(6))
    nb = recv_w.shape[1]
    shift = torch.arange(world, device=dev).repeat_interleave(nb) * nb
    w_rel = float(((recv_w - r_w).abs() / r_w.abs().clamp_min(1e-30)).max())
    delta = float((_counting_cdf(torch, recv_w) - torch.cat(
        [_counting_cdf(torch, f[1]) for f in ranks])).abs().max())
    slots = int((starts - (r_starts + shift)).abs().max())
    allowed = math.floor(nb * delta + 0.25) + 1
    require(torch.equal(u2, r_u2) and torch.equal(recv_x, r_x),
            "processes: the one-process resampler, replayed on the ranks' "
            "first resample, draws other offsets u2 or sends other blocks")
    require(w_rel <= 1e-5 and delta <= 1e-5 and slots <= allowed,
            f"processes: the one-process resampler, replayed on the ranks' "
            f"first resample, weighs the received blocks by rtol {w_rel}, "
            f"counts over CDFs {delta} apart and moves a first slot by "
            f"{slots} (at most {allowed} allowed)")
    moved = int((x_anc != r_anc).any(dim=-1).sum())
    anc = shard_systematic_ancestors(u1, wv.sum(dim=1)).tolist()
    return (f"processes: the one-process resampler of {world} shards, "
            f"replayed on the ranks' first resample, draws their offsets u2 "
            f"and sends each shard its block to the bit, the ancestor shards "
            f"{anc}; the received weights "
            f"within rtol {w_rel:.3g}, their CDFs within {delta:.3g} (one "
            f"process scans {world} rows at once, a rank one), every first "
            f"slot within {slots} of the rank's (at most {allowed}); "
            f"{int((m != r_m).sum())} of {m.numel()} copy counts and "
            f"{moved} slots' particles differ")


def _parted_designs(torch, dev, ring, one, kept, part):
    """Where the PGH designs of the ranks' precession ring run and the
    one-process run part (step ``part``): both t there, and, where both
    runs kept that step's draws (before the first resample:
    ``worker.recorders``), the draws replayed from each run's generator
    state and ensemble (``worker.replay_pgh``), which must give each
    run's t to the bit, from the same generator state: the particles
    each run's inverse CDF picked. Returns the line that says so."""
    from qinfer_tpu_torch.ops.accelerated import AcceleratedPrecessionModel
    from qinfer_tpu_torch.parallel.worker import replay_pgh

    t_ranks, t_one = ring["t_record"][part], one["t_record"][part]
    text = (f"processes: the designs part at step {part}: t = {t_ranks!r} "
            f"on the ranks, {t_one!r} in one process")
    if part >= min(len(kept[0]["designs"]), len(one["designs"])):
        return text + " (the draws of that step are not kept)"
    model = AcceleratedPrecessionModel()
    state, one_w, one_x = one["designs"][part]
    blocks = [k["designs"][part] for k in kept]
    ranks_w = [b[1].to(dev) for b in blocks]
    t_r, (i_r, j_r) = replay_pgh(model, blocks[0][0], ranks_w,
                                 [b[2].to(dev) for b in blocks])
    t_o, (i_o, j_o) = replay_pgh(model, state, [one_w], [one_x])
    w_rel = float(((torch.cat(ranks_w) - one_w).abs()
                   / one_w.abs().clamp_min(1e-30)).max())
    require(all(torch.equal(b[0], state) for b in blocks)
            and t_r == t_ranks and t_o == t_one,
            f"processes: step {part}'s PGH draws, replayed, give t = {t_r} "
            f"over the ranks and {t_o} in one process, or start from "
            f"different generator states")
    return (text + f"; replayed from the same generator state, the inverse "
            f"CDF picked particles {i_r} and {j_r} over the ranks' blocks, "
            f"{i_o} and {j_o} over the one process's ensemble, the weights "
            f"there within rtol {w_rel:.3g}")


def _check_processes(torch, dev, card, world, one, side, config5_mean):
    """The checks of :func:`run_processes_path` on the one-process runs
    ``one`` (:func:`_one_process`) and the ranks' ``side``
    (:func:`_on_ranks`); ``config5_mean`` (the unsharded run's, or None)
    is printed beside config 5's. Returns what
    :func:`run_processes_path` does."""
    from qinfer_tpu_torch.ops import precession as prec
    from qinfer_tpu_torch.ops import streaming_resample as sr

    n, steps, _ = PARALLEL
    cn, csteps, ccand = CONFIG5
    results, kept = side["results"], side["kept"]
    timer = results[0]["card"][0]["collective_timer"]
    one_est, one_resamples, one_sd = one["est"], one["resamples"], one["sd"]
    one_est_record, one_ess, one_c5 = one["est_record"], one["ess"], one["c5"]
    for task in ("precession", "config5"):
        lines = [res.get(task, []) for res in results]
        require(all(len(ln) == (2 if task == "precession" else 1)
                    for ln in lines)
                and all([_replicated(a) for a in ln]
                        == [_replicated(a) for a in lines[0]]
                        for ln in lines),
                f"processes {task}: the ranks' replicated results differ")
    ring, butterfly = results[0]["precession"]
    require(all(ring[k] == butterfly[k]
                for k in ("est", "resamples", "log_evidence", "est_record"))
            and all(res["precession"][1]["local_ring_equals_butterfly"]
                    for res in results),
            "processes: the ring and butterfly runs differ")
    est = ring["est"]
    require(abs(est - 0.7) < 0.05 and ring["finite"],
            f"processes: est {est}, not within 0.05 of 0.7")
    for r, res in enumerate(results):
        for run in res["precession"]:
            got = run["local_launches"]
            require(got["fused_precession_update"] == steps
                    and got["precession_pr0"] == steps
                    and got["streaming_resample_locations"]
                    == run["resamples"] >= 1
                    and all(v == 0 for k, v in got.items()
                            if k.startswith("jacobi")),
                    f"processes rank {r} {run['exchange']}: launches {got} "
                    f"for {steps} steps and {run['resamples']} resamples")
    d_est, d_res = abs(est - one_est), abs(ring["resamples"] - one_resamples)
    # the runs make the same steps until their PGH designs part (the
    # inverse CDF over 2²² weights of 2⁻²² rounds otherwise in the two
    # layouts) or the first resample does, which leaves uniform weights:
    # ESS n
    part = next((i for i, (a, b) in enumerate(zip(ring["t_record"],
                                                   one["t_record"]))
                 if a != b), steps)
    first = next((i for i, e in enumerate(one_ess) if e >= n * (1 - 1e-4)),
                 None)
    require(first is not None and (
        part <= first or abs(ring["ess_record"][first] - n) <= 1e-4 * n),
        f"processes: the first resample (one-process step {first}, the "
        f"designs alike through step {part - 1}) is not the ranks' too")
    alike = min(part, first)
    rel = max((abs(a - b) / abs(b) for a, b in zip(
        ring["est_record"][:alike], one_est_record[:alike])), default=0.0)
    sd = math.hypot(ring["posterior_sd"], one_sd)
    say("main", f"processes: {world} ranks against the one-process "
                f"mesh of {world} shards: est {est:.9f} / "
                f"{one_est:.9f} (|Δ| {d_est:.3g}, combined posterior sd "
                f"{sd:.3g}), resamples {ring['resamples']} / "
                f"{one_resamples} (|Δ| {d_res}); the designs part at step "
                f"{part}, the first resample at step {first}; the estimates "
                f"of the {alike} steps before either within rtol {rel:.3g}")
    require(rel <= 1e-5, f"processes: the ranks' estimates part from the "
                         f"one-process mesh's by rtol {rel} before step "
                         f"{alike}")
    require(d_est < 1e-4 and d_est < 5 * sd
            and d_res <= PROCESS_RESAMPLE_BAR,
            f"processes: {world} ranks and the one-process mesh differ "
            f"by {d_est} in the estimate ({sd} combined sd) and {d_res} "
            f"resamples")
    if part < steps:
        say("main", _parted_designs(torch, dev, ring, one, kept, part))
    if part > first:
        _held_first_resample(torch, dev, n, kept, one, ring, first)
    else:
        say("main", f"processes: the designs part at step {part}, before "
                    f"the first resample: from there the runs are held by "
                    f"law")
    say("main", _replayed_first_resample(torch, dev, world, kept))
    for run in (ring, butterfly):
        stage = [res["precession"][run is butterfly]["local_collective_s"]
                 for res in results]
        say("main", f"processes {run['exchange']}: {run['wall_s']:.4f} s "
                    f"for {n} particles x {steps} steps on {world} "
                    f"ranks = {run['updates_per_s']:.6g} "
                    f"particle-updates/s, est {run['est']:.6f}, "
                    f"{run['resamples']} resamples, {run['collective_calls']}"
                    f" collectives a rank taking {min(stage):.4f}-"
                    f"{max(stage):.4f} s (by {timer}), launches a rank "
                    f"{run['local_launches']} on {card}")
    c5 = results[0]["config5"][0]
    got = c5["local_launches"]
    require(abs(c5["posterior_mean"] - 0.7) < 0.05,
            f"processes config 5: posterior mean {c5['posterior_mean']}")
    require(all(res["config5"][0]["local_launches"]
                ["streaming_resample_locations"] == 2 * c5["resamples"]
                for res in results),
            f"processes config 5: launches {got} for {c5['resamples']} "
            f"resamples of each of its two runs")
    d_mean = abs(c5["posterior_mean"] - one_c5["posterior_mean"])
    d_res = abs(c5["resamples"] - one_c5["resamples"])
    sd = math.hypot(c5["posterior_sd"], one_c5["posterior_sd"])
    # the runs make the same steps until their designs part (PGH's
    # inverse CDF over 10⁷ weights of 1e-7, not dyadic, rounds otherwise
    # in the two layouts) or the first resample does
    part = next((i for i, (a, b) in enumerate(zip(c5["t_record"],
                                                   one_c5["t_record"]))
                 if a != b), csteps)
    first = next((i for i, c in enumerate(one_c5["resample_record"]) if c),
                 csteps)
    alike = min(part, first)
    rel = max((abs(a - b) / abs(b) for a, b in zip(
        c5["mean_record"][:alike], one_c5["mean_record"][:alike])),
        default=0.0)
    say("main", f"processes config 5: {world} ranks against the "
                f"one-process mesh of {world} shards: posterior mean "
                f"{c5['posterior_mean']:.9f} / {one_c5['posterior_mean']:.9f}"
                f" (|Δ| {d_mean:.3g}, combined posterior sd {sd:.3g}), "
                f"resamples {c5['resamples']} / {one_c5['resamples']} (|Δ| "
                f"{d_res}); the designs part at step {part}, the first "
                f"resample at step {first}; the means of the {alike} steps "
                f"before either within rtol {rel:.3g}")
    require(rel <= 1e-5 and (part <= first or first == csteps
                             or c5["resample_record"][first] == 1),
            f"processes config 5: with the same designs, the ranks' means "
            f"part from the one-process mesh's by rtol {rel} before step "
            f"{alike}, or their first resample comes at another step")
    require(d_mean < 5 * sd and d_res <= PROCESS_RESAMPLE_BAR,
            f"processes config 5: {world} ranks and the one-process "
            f"mesh differ by {d_mean} in the mean ({sd} combined sd) and "
            f"{d_res} resamples")
    say("main", f"processes config 5 on {world} ranks: "
                f"{c5['wall_s']:.4f} s for {c5['particles']} particles x "
                f"{csteps} steps x {ccand} candidates = "
                f"{c5['particle_updates_per_s']:.6g} particle-updates/s, "
                f"posterior mean {c5['posterior_mean']:.6f} "
                + (f"(|Δ| {abs(c5['posterior_mean'] - config5_mean):.3g} "
                   f"from the unsharded plain Liu-West run's "
                   f"{config5_mean:.6f}), " if config5_mean is not None
                   else "")
                + f"{c5['resamples']} resamples, {c5['collective_calls']} "
                f"collectives a rank over warm-up and timed run taking "
                f"{c5['local_collective_s']:.4f} s (rank 0, by {timer}), "
                f"launches over both runs {got} on {card}")

    # (c) the kernels at the ranks' shapes, on each rank's own inputs
    for r, rank in enumerate(kept):
        omega, w, t, outcome = (v.to(dev) if torch.is_tensor(v) else v
                                for v in rank["k1"])
        k1_err = hold_k1(omega, w, t, outcome, f"at rank {r}'s last step")
        u2, recv_w, recv_x, m_rank, starts_rank, x_rank = (
            v.to(dev) for v in rank["fill"])
        rows = recv_x.shape[0] * recv_x.shape[1]
        m, starts, flat, _ = _replay_batch_fill(
            torch, dev, u2, recv_w, recv_x, f"processes rank {r}")
        plain = sr.streaming_resample_locations_plain(m_rank, starts_rank,
                                                      flat)
        require(torch.equal(m, m_rank) and torch.equal(starts, starts_rank)
                and torch.equal(plain.view(torch.int32), x_rank.reshape(
                    rows, -1).view(torch.int32)),
                f"processes rank {r}: the rank's K3 fill differs from the "
                f"plain twin on its counts")
        say("main", f"processes rank {r}: K1 at its last step (n = "
                    f"{omega.shape[0]}, t = {t:.6g}) against its plain "
                    f"version: max |dh| = {k1_err:.3g}; its first fill's K3 "
                    f"launch over {recv_x.shape[0]} x {recv_x.shape[1]} rows "
                    f"equal to the plain twin to the bit")
        if r == 0:
            k1 = (omega, w, t, outcome, k1_err)
            k3 = (m, starts, flat, rows)
    legs_launches, trials_launches, leg_entries = _check_process_legs(
        torch, dev, card, world, results, side["resumed"], one["legs"],
        side["kept_legs"], side["loaded"])
    launches = ring["local_launches"]
    omega, w, t, outcome, k1_err = k1
    nk = omega.shape[0]
    k1_args, k1_bytes = (omega, w, t, outcome), 12 * nk
    k1_entry = timed(
        f"fused_precession_update n={nk} (processes: rank 0's last step of "
        f"the ring run, t = {t:.6g}, outcome {outcome}, its inputs in "
        f"device memory)",
        from_device_memory(lambda *a: prec.fused_precession_update(
            *a, normalize=False), k1_args, k1_bytes),
        from_device_memory(lambda *a: prec.fused_precession_update_plain(
            *a, normalize=False), k1_args, k1_bytes),
        no_library="no one PyTorch call fuses the reweight and its sums",
        bound_at=bound(k1_bytes, 10 * nk),
        attach=dict(kernel="fused_precession_update",
                    launches=launches["fused_precession_update"],
                    max_abs_err=k1_err))
    m, starts, flat, rows = k3
    fill_bytes = k3_bytes(m, 1)
    k3_entry = timed(
        f"streaming_resample_locations n={rows}, d=1 (processes: rank 0's "
        f"first fill, one launch over its 1 x {rows} rows, its inputs in "
        f"device memory)",
        from_device_memory(sr.streaming_resample_locations,
                           (m, starts, flat), fill_bytes),
        from_device_memory(sr.streaming_resample_locations_plain,
                           (m, starts, flat), fill_bytes),
        library=from_device_memory(
            lambda m, f: torch.repeat_interleave(f, m, dim=0,
                                                 output_size=rows),
            (m, flat), fill_bytes),
        bound_at=k3_bound(m, 1),
        attach=dict(kernel="streaming_resample_locations",
                    launches=launches["streaming_resample_locations"]))
    return (launches, legs_launches, trials_launches,
            [k1_entry, k3_entry] + leg_entries)


def run_one_rank_nccl(torch, dev, card):
    """Phase 5: a one-rank NCCL group on the card runs the worker's
    ``collectives`` task. Its results equal those of the one-process
    mesh of one shard: the collectives on the fixed blocks and the
    engine's values to the bit (``parallel.worker.fixed_blocks``,
    ``engine_values``), but for the five draws of ``sample``, which a
    process mesh draws by the inverse CDF over the ranks and one process
    multinomially: those must be rows of the ensemble. The checkpoint
    reloads on the rank, and its collectives were timed by CUDA
    events."""
    from qinfer_tpu_torch.parallel import ParticleMesh
    from qinfer_tpu_torch.parallel.worker import engine_values, fixed_blocks

    t0 = time.perf_counter()
    got = _run_ranks(torch, 1, "nccl", "collectives")[0]["collectives"][0]
    mesh = ParticleMesh([dev])
    u, want = engine_values(mesh)
    block = fixed_blocks(mesh)
    rows = set(u.particle_locations[:, 0].tolist())
    sample = got["engine"].pop("sample")
    want.pop("sample")
    require(got["collective_timer"] == "CUDA events on the current stream"
            and got["spans_processes"] and got["n_devices"] == 1,
            f"one-rank NCCL: {got['n_devices']} ranks timed by "
            f"{got['collective_timer']}")
    require(got["engine"] == json.loads(json.dumps(want)),
            f"one-rank NCCL: the engine's values {got['engine']} differ from "
            f"the one-process mesh's {want}")
    require(got["psum"] == mesh.psum(block).tolist()
            and got["all_gather"] == mesh.all_gather(block).tolist()
            and all(got["local_ppermute"][str(k)]
                    == mesh.ppermute(block, k)[0].tolist()
                    for k in (-1, 0, 1)),
            "one-rank NCCL: the collectives differ from the one-process "
            "mesh's")
    require(all(r[0] in rows for r in sample) and got["reloaded"],
            f"one-rank NCCL: the draws {sample} are not all particles, or "
            f"the checkpoint did not reload ({got['reloaded']})")
    say("main", f"one-rank NCCL group on {got['device']}: psum, all_gather, "
                f"ppermute and the engine's values ({', '.join(want)}) equal "
                f"the one-process mesh of one shard to the bit, the draws "
                f"particles of the ensemble, the checkpoint reloaded; "
                f"{time.perf_counter() - t0:.1f} s with the process's start, "
                f"on {card}")


def _timing_key(key):
    """Whether a worker's RESULT key holds a time, a rate, a clock's name
    or a memory peak (the rest of a line is what a run computed)."""
    return (key.endswith("_s") or key in ("collective_timer",
                                          "peak_memory_bytes"))


def _same_bits(nccl, gloo):
    """Bar (b) of :func:`run_cards`: each rank's every RESULT line under
    NCCL equals the same rank's under gloo, all but its times
    (:func:`_timing_key`): the same bits, counts and checksums."""
    for r, (a, b) in enumerate(zip(nccl["results"], gloo["results"])):
        for task in ("precession", "config5", "runs", "trials"):
            require(len(a[task]) == len(b[task]),
                    f"cards: rank {r}'s {task} lines differ in number")
            for x, y in zip(a[task], b[task]):
                differ = sorted(k for k in set(x) | set(y)
                                if not _timing_key(k) and x.get(k) != y.get(k))
                require(not differ,
                        f"cards: rank {r}'s {task} "
                        f"{x.get('run', x.get('exchange', ''))} under NCCL "
                        f"differs from gloo's in {differ}")


def _collectives_line(what, nccl, gloo, one_wall=None):
    """One line of collectives a rank under NCCL against gloo on the same
    cards: ``nccl`` and ``gloo`` each rank's RESULT line of one run."""
    def spread(lines, key):
        vals = [ln[key] for ln in lines]
        return f"{min(vals):.4f}-{max(vals):.4f}"

    key = ("local_run_collective_s" if "local_run_collective_s" in nccl[0]
           else "local_collective_s")
    calls = ("run_collective_calls" if "run_collective_calls" in nccl[0]
             else "collective_calls")
    wall = "local_run_s" if "local_run_s" in nccl[0] else "wall_s"
    say("main", f"cards {what}: NCCL {nccl[0][calls]} collectives a rank "
                f"taking {spread(nccl, key)} s ({nccl[0]['collective_timer']}"
                f"), the run {spread(nccl, wall)} s; gloo {gloo[0][calls]} "
                f"taking {spread(gloo, key)} s ({gloo[0]['collective_timer']}"
                f"), the run {spread(gloo, wall)} s"
                + (f"; one process {one_wall:.4f} s" if one_wall is not None
                   else ""))


def card_lines(query="name,power.limit"):
    """Every card's ``query`` fields as nvidia-smi reports them
    (``--query-gpu``, ``csv,noheader``), a line each."""
    import subprocess

    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0 and out.stdout.strip(),
            f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def power_limits():
    """Every card's power limit as nvidia-smi reports it, by its UUID
    (without ``GPU-``)."""
    rows = [line.split(", ") for line in
            card_lines("uuid,power.limit").splitlines()]
    return {uuid.removeprefix("GPU-"): limit for uuid, limit in rows}


def run_cards(torch, dev, card):
    """``--cards 4``: the process phase's legs over ``CARDS`` ranks, one a
    card, (1) by NCCL (the precession runs, config 5, the legs and the
    trials, then the resample-move leg resumed on fresh NCCL ranks and
    its archive loaded into one process: :func:`_on_ranks`), (2) by gloo
    on the same cards, (3) on a one-process mesh of ``CARDS`` shards of
    card 0 (:func:`_one_process`), at the process phase's widths but the
    waste-free leg's ``CARDS_WASTE_FREE``. Its bars: (a) under NCCL the
    ranks agree to the bit; (b) each rank's NCCL lines equal its gloo
    lines to the bit, but for their times (:func:`_same_bits`); (c)
    against the one-process mesh, the process phase's bars; (d) the
    resume on fresh NCCL ranks to the bit, and the archive loaded into
    one process equal to the ranks' blocks; (e) each rank's K1 (n =
    2²⁰), K3 (1 x 2²⁰ rows, and 1 x 12 500 rows at d = 255) and K5
    ((12 500, 32, 32)) on its recorded inputs equal to their plain
    versions, and rank 0's timed from device memory; (f) each rank's card
    (name, PCI bus id and UUID from the rank, power limit from
    nvidia-smi), all bus ids and UUIDs distinct. Prints ``nvidia-smi topo -m`` (or why it cannot) and CUDA's
    peer access between the cards first, and each leg's collectives a
    rank under NCCL and gloo. Returns the kernels' results (K1, K3, K5),
    each with its launches on every rank (``launches_ranks``;
    ``launches``: rank 0's)."""
    import subprocess

    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    print(topo.stdout.rstrip() or topo.stderr.rstrip(), flush=True)
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j)
              for j in range(CARDS)] for i in range(CARDS)]
    say("main", f"cards: peer access between the cards (CUDA), row i "
                f"column j: {peers}")
    t_phase = time.perf_counter()
    nccl = _on_ranks(torch, dev, CARDS, "nccl")
    say("main", f"cards: {CARDS} NCCL ranks and the resume on fresh ranks in "
                f"{time.perf_counter() - t_phase:.1f} s")
    ids = [res["card"][0] for res in nccl["results"]]
    limits = power_limits()
    for r, line in enumerate(ids):
        info = line["local_card"]
        require(info["uuid"] in limits,
                f"cards: nvidia-smi lists no card of UUID {info['uuid']}: "
                f"{limits}")
        say("main", f"cards rank {r} on {line['device']}: {info['name']}, "
                    f"PCI bus {info['pci_bus_id']}, UUID {info['uuid']}, "
                    f"power limit {limits[info['uuid']]} (nvidia-smi)")
    require(len({ln["device"] for ln in ids}) == CARDS
            and all(len({ln["local_card"][k] for ln in ids}) == CARDS
                    for k in ("pci_bus_id", "uuid")),
            f"cards: the {CARDS} ranks do not hold {CARDS} distinct cards: "
            f"{ids}")
    gloo = _on_ranks(torch, dev, CARDS, "gloo", resume=False)
    _same_bits(nccl, gloo)
    say("main", f"cards: every rank's lines of the precession runs, config "
                f"5, the legs and the trials under NCCL equal its gloo lines "
                f"to the bit, but for their times")
    one = _one_process(torch, dev, CARDS)
    entries = _check_processes(torch, dev, card, CARDS, one, nccl, None)[-1]
    for task in ("precession", "config5", "runs", "trials"):
        for i, line in enumerate(nccl["results"][0][task]):
            what = line.get("run", line.get("exchange", ""))
            _collectives_line(
                f"{task} {what}".strip(),
                [res[task][i] for res in nccl["results"]],
                [res[task][i] for res in gloo["results"]],
                one["legs"][what]["local_run_s"] if task == "runs" else None)
    say("main", f"cards: the phase {time.perf_counter() - t_phase:.1f} s")
    # each kernel's launches on every rank's run of the path that carries
    # it: the ring run (K1-K3), the resample-move leg (K5, K6)
    ranks = {name: [res[task][0]["local_launches"][name]
                    for res in nccl["results"]]
             for name, task in (("fused_precession_update", "precession"),
                                ("precession_pr0", "precession"),
                                ("streaming_resample_locations",
                                 "precession"),
                                ("jacobi_project_lanes_looped", "runs"),
                                ("jacobi_eigh_lanes", "runs"))}
    say("main", f"cards: launches a rank {ranks}")
    timers, rest = [], []
    for e in entries:
        name = e["attach"]["kernel"]
        if name in [t["result"]["name"] for t in timers]:
            rest.append(e)
            continue
        result = kernel_result(name, shape=e["result"], max_abs_err=0.0,
                               launches_ranks=ranks[name])
        result.update((k, v) for k, v in e["attach"].items() if k != "kernel")
        timers.append(dict(e, result=result, attach=None))
    return time_kernels(timers, rest)


def main(argv):
    kernels_only = argv == ["--kernels-only"]
    on_cards = argv == ["--cards", str(CARDS)]
    require(not argv or kernels_only or on_cards,
            f"usage: chip_smoke.py [--kernels-only | --cards {CARDS}], got "
            f"{argv}")
    sys.path.insert(0, ROOT)
    try:
        import torch
    except ImportError as exc:
        raise SmokeFailure(f"torch is not installed: {exc}")
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    present = torch.cuda.device_count()
    require(not on_cards or present >= CARDS,
            f"--cards {CARDS} runs one rank on each of {CARDS} cards, and "
            f"{present} are present: it runs on no fewer")
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

    if on_cards:
        results = run_cards(torch, dev, card)
        require("jax" not in sys.modules, "JAX was imported")
        print(json.dumps({"kernels": results}))
        print(card_lines(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": present}}))
        return
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
    config5_entry, config5_state, config5_mean = run_config5(torch, dev,
                                                             card)
    extra.append(config5_entry)
    extra.extend(run_models_path(torch, dev, card))
    item8_entries, item8_k4 = run_item8_path(torch, dev, card)
    extra.extend(item8_entries)
    trials_entries, trials_k1 = run_trials_path(torch, dev, card)
    extra.extend(trials_entries)
    resume_launches = run_resume_path(torch, dev, card)
    parallel_launches, flagship_launches, parallel_entry = run_parallel_path(
        torch, dev, card, config5_state, config5_mean)
    extra.append(parallel_entry)
    (process_launches, process_legs_launches, process_trials_launches,
     process_entries) = run_processes_path(torch, dev, card, config5_mean)
    extra.extend(process_entries)
    run_one_rank_nccl(torch, dev, card)
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
        if r["name"] not in resume_launches:
            continue  # the counting pass: counted on the main path only
        if resume_launches[r["name"]]:
            r["launches_resume"] = resume_launches[r["name"]]
        # the sharded precession run (a), or the flagship leg on 8 shards
        # for the kernels run (a) does not launch
        r["launches_parallel"] = (parallel_launches[r["name"]]
                                  or flagship_launches[r["name"]])
        # rank 0 of the process phase's ring run, of its resample-move leg
        # and of its trials
        r["launches_processes"] = process_launches[r["name"]]
        r["launches_processes_resample_move"] = process_legs_launches[
            r["name"]]
        r["launches_processes_trials"] = process_trials_launches[r["name"]]
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
