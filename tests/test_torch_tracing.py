"""``qinfer_tpu_torch.tracing``: the spans and host-read counters inside the
update, the resampler, the moves and PGH, on the CPU at test sizes.

Off, nothing is recorded. On, every output is equal to the bit to a run
with recording off from the same seed, the spans nest as the engine's
layers do, and ``host_reads`` counts every device→host conversion the
code makes: each test counts the tensors' conversions (``bool``, ``int``,
``float``, ``item``, ``tolist``, ...) independently and finds the same
number with recording on and off.
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch

from qinfer_tpu_torch import rejuvenation as rj
from qinfer_tpu_torch import tomography_bench as tb
from qinfer_tpu_torch import tracing
from qinfer_tpu_torch.derived_models import BinomialModel, PoisonedModel
from qinfer_tpu_torch.distributions import UniformDistribution
from qinfer_tpu_torch.heuristics import PGH
from qinfer_tpu_torch.ops.accelerated import AcceleratedPrecessionModel
from qinfer_tpu_torch.resamplers import LiuWestResampler
from qinfer_tpu_torch.smc import SMCState, SMCUpdater, _update_step
from qinfer_tpu_torch.test_models import SimplePrecessionModel

#: the parent of each span (``resample`` is a root when called directly)
PARENTS = {
    "update": {None},
    "update.reweight": {"update"},
    "update.read": {"update"},
    "resample": {"update", None},
    "resample.ancestors": {"resample"},
    "resample.proposal": {"resample"},
    "resample.project": {"resample"},
    "moves": {None},
    "moves.factor": {"moves"},
    "moves.propose": {"moves"},
    "moves.posterior": {"moves"},
    "design": {None},
}

#: the tensor methods through which a value comes to the host
CONVERSIONS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "numpy", "cpu")


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tracing.reset()
    torch.set_num_threads(threads)


@contextlib.contextmanager
def conversions():
    """Count the calls of :data:`CONVERSIONS` inside the block."""
    seen = []
    saved = {name: getattr(torch.Tensor, name) for name in CONVERSIONS}

    def wrap(name, method):
        def counted(self, *args, **kwargs):
            seen.append(name)
            return method(self, *args, **kwargs)
        return counted

    for name, method in saved.items():
        setattr(torch.Tensor, name, wrap(name, method))
    try:
        yield seen
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


# -- the cases: each returns (outputs, the reads it expects by site) ------

def _precession_updater(thresh):
    return SMCUpdater(AcceleratedPrecessionModel(), 2048,
                      UniformDistribution([[0.0, 1.0]]),
                      resample_thresh=thresh,
                      resampler=LiuWestResampler(a=0.98, maxiter=10),
                      seed=11, device="cpu")


def _precession_step(thresh):
    """Set-up outside the recording: the updater and its first design."""
    upd = _precession_updater(thresh)
    pgh = PGH(upd)
    eps = pgh(0)

    def step():
        upd.update(1, eps)
        nxt = pgh(1)
        st = upd.state
        expect = {"update.read": 1}
        if st.just_resampled:
            rounds = upd.resampler.redraw_rounds[-1]
            expect.update({"resample.chol_verdict": 1,
                           "resample.validity": _checks(rounds, 10),
                           "update.fallback": 1})
        return (_fields(st), list(nxt.values())), expect
    return step


def _fields(state):
    """Every field of an :class:`SMCState`."""
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


def _checks(rounds, maxiter):
    """Validity checks of a call with ``rounds`` redraw rounds: one a
    round and the last, passed, one; none after the last round allowed."""
    return rounds if rounds == maxiter else rounds + 1


def _process_step():
    cfg = tb.process_config(2, torch.device("cpu"))
    model = BinomialModel(cfg.model, n_meas_max=64)
    gen = torch.Generator().manual_seed(3)
    state = SMCState.initial(cfg.prior.sample(gen, 512))
    eps = {k: v[5:6] for k, v in cfg.pool_eps.items()}
    eps = dict(eps,
               n_meas=torch.tensor([64], dtype=torch.int32))
    resampler = LiuWestResampler(a=0.98, maxiter=4, canonicalize=True)

    def step():
        new, log_norm, was_zero = _update_step(
            model, resampler, state, torch.tensor([40]), eps, 1.0, 1e-10,
            gen, check_resample=True, resample_gate=True)
        assert new.just_resampled
        rounds = resampler.redraw_rounds[-1]
        expect = {"update.read": 1, "resample.chol_verdict": 1,
                  "resample.validity": _checks(rounds, 4),
                  "project.verdict": 1}
        return (_fields(new), log_norm, was_zero), expect
    return step


def _process_resampler(n):
    """The resampler called directly: ``resample`` is a root. Fewer
    particles than the 255 parameters give a singular covariance, which
    Cholesky refuses: the factor's rows are read for the square root."""
    cfg = tb.process_config(2, torch.device("cpu"))
    gen = torch.Generator().manual_seed(4)
    x = cfg.prior.sample(gen, n)
    w = torch.rand((n,), generator=gen)
    w = w / w.sum()
    resampler = LiuWestResampler(a=0.98, maxiter=4, canonicalize=True)

    def step():
        new_w, new_x, n_fallback = resampler.call_with_diagnostics(
            cfg.model, gen, w, x)
        rounds = resampler.redraw_rounds[-1]
        expect = {"resample.chol_verdict": 1,
                  "resample.validity": _checks(rounds, 4),
                  "project.verdict": 1}
        if n < 255:
            expect["resample.chol_rows"] = 1
        return (new_w, new_x, n_fallback), expect
    return step


def _process_moves(method, canonicalize):
    cfg = tb.process_config(2, torch.device("cpu"))
    model = BinomialModel(cfg.model, n_meas_max=64)
    gen = torch.Generator().manual_seed(5)
    x = cfg.prior.sample(gen, 128)
    n_pool = cfg.pool_eps["prep"].shape[0]
    trials = torch.full((n_pool,), 64, dtype=torch.int32)
    succ = torch.randint(0, 65, (n_pool,), generator=gen, dtype=torch.int32)

    def step():
        out = rj.mcmc_rejuvenate_binomial_adaptive(
            model, cfg.prior, gen, x, succ, trials, cfg.pool_eps, 3,
            rj.initial_log_scale(int(model.n_modelparams), method), 0,
            method=method, canonicalize=canonicalize)
        expect = {"moves.chol_verdict": 1}
        if canonicalize:
            expect["project.verdict"] = 1
        return out, expect
    return step


def _keyed_moves():
    """A Monte-Carlo likelihood: the call reads its sweeps' seed."""
    model = PoisonedModel(SimplePrecessionModel(), tol=0.01)
    prior = UniformDistribution([[0.0, 1.0]])
    gen = torch.Generator().manual_seed(6)
    x = prior.sample(gen, 256)
    eps = {"t": torch.tensor([2.0, 5.0])}

    def record_ll(xx, g=None):
        return torch.log(torch.clamp_min(model.likelihood(
            torch.tensor([0]), xx, eps, generator=g)[0].sum(dim=-1), 1e-30))

    def step():
        out = rj._mh_moves_adaptive(model, prior, gen, x, record_ll, 3,
                                    -1.0, 0, "rwm", 0.234, False)
        return out, {"moves.chol_verdict": 1, "moves.crn_seed": 1}
    return step


CASES = {
    "precession-update": lambda: _precession_step(0.0),
    "precession-resample": lambda: _precession_step(1.0),
    "process2q-resample": _process_step,
    "process2q-resampler": lambda: _process_resampler(512),
    "process2q-resampler-singular": lambda: _process_resampler(128),
    "process2q-moves-rwm": lambda: _process_moves("rwm", False),
    "process2q-moves-mala-projected": lambda: _process_moves("mala", True),
    "keyed-moves": _keyed_moves,
}


def _flat(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [torch.as_tensor(out)]


def _run(case, record):
    step = CASES[case]()
    with (tracing.recording("cpu") if record else contextlib.nullcontext()):
        with conversions() as seen:
            out, expect = step()
    return _flat(out), expect, len(seen)


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_equal_to_the_bit_with_recording_on(case):
    off, _, reads_off = _run(case, False)
    assert tracing.snapshot()["spans"] == []
    on, _, reads_on = _run(case, True)
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # recording reads nothing from the device
    assert reads_on == reads_off


@pytest.mark.parametrize("case", list(CASES))
def test_host_reads_by_site_are_the_reads_the_code_makes(case):
    _, expect, seen = _run(case, True)
    reads = tracing.snapshot()["host_reads"]
    assert reads == expect
    assert sum(reads.values()) == seen


@pytest.mark.parametrize("case", list(CASES))
def test_span_tree(case):
    _run(case, True)
    snap = tracing.snapshot()
    names = {s[0] for s in snap["spans"]}
    assert names and names <= set(PARENTS)
    for name, parent, step, start, end in snap["spans"]:
        assert parent in PARENTS[name], (name, parent)
        assert start <= end
    # every parent holds its children's intervals
    spans = snap["spans"]
    for name, parent, _, start, end in spans:
        if parent is not None:
            assert any(p[0] == parent and p[3] <= start and end <= p[4]
                       for p in spans), name
    counts = {}
    for s in spans:
        counts[s[0]] = counts.get(s[0], 0) + 1
    assert {k: v[0] for k, v in snap["totals"].items()} == counts
    # on the CPU the spans' "device" time is the host's
    for count, device_s, host_s in snap["totals"].values():
        assert device_s == pytest.approx(host_s) and host_s >= 0.0
    assert snap["timer"] == "host clock"


@pytest.mark.parametrize("case, phases", [
    ("precession-resample", {"update", "update.reweight", "update.read",
                             "resample", "resample.ancestors",
                             "resample.proposal", "resample.project",
                             "design"}),
    ("precession-update", {"update", "update.reweight", "update.read",
                           "design"}),
    ("process2q-resample", {"update", "update.reweight", "update.read",
                            "resample", "resample.ancestors",
                            "resample.proposal", "resample.project"}),
    ("process2q-moves-rwm", {"moves", "moves.factor", "moves.propose",
                             "moves.posterior"}),
])
def test_each_layer_has_its_phases(case, phases):
    _run(case, True)
    snap = tracing.snapshot()
    assert set(snap["totals"]) == phases
    if "moves.propose" in phases:
        # one propose and one posterior span a sweep
        assert snap["totals"]["moves.propose"][0] == 3
        assert snap["totals"]["moves.posterior"][0] == 3


def test_nothing_is_recorded_while_off():
    for case in ("precession-resample", "process2q-moves-rwm"):
        _run(case, False)
    assert tracing.snapshot() == {"spans": [], "totals": {},
                                  "host_reads": {}, "steps": 0,
                                  "timer": "host clock"}


def test_step_id_counts_the_update_roots():
    upd = _precession_updater(0.5)
    pgh = PGH(upd)
    with tracing.recording("cpu"):
        for k in range(4):
            eps = pgh(k)
            upd.update(k % 2, eps)
        pgh(4)
    snap = tracing.snapshot()
    assert snap["steps"] == 4
    by_step = {}
    for name, parent, step, _, _ in snap["spans"]:
        if parent is None:
            by_step.setdefault(step, []).append(name)
    # the first design comes before any update; each step then updates
    # and designs the next experiment
    assert by_step == {0: ["design"],
                       **{k: ["update", "design"] for k in range(1, 5)}}
    assert snap["host_reads"]["update.read"] == 4


def test_recordings_do_not_nest_and_reset_drops_everything():
    with tracing.recording("cpu"):
        with pytest.raises(RuntimeError):
            with tracing.recording("cpu"):
                pass
        with pytest.raises(RuntimeError):
            tracing.reset()
        with tracing.span("design"):
            tracing.host_read("update.read")
    assert tracing.snapshot()["host_reads"] == {"update.read": 1}
    tracing.reset()
    assert tracing.snapshot()["spans"] == []
    # a span opened while off records nothing when recording starts inside
    with tracing.span("update"):
        with tracing.recording("cpu"):
            pass
    assert tracing.snapshot()["totals"] == {}

