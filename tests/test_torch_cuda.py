"""The port's hand-written CUDA kernels against their plain PyTorch
versions ON THE CARD, at small and ragged shapes (chip_smoke.py checks the
main path's shapes). Every test here is marked ``cuda`` and skips without
a CUDA device. The module imports no JAX, so it runs on a machine that
has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from qinfer_tpu_torch.ops import counting_pass as cp
from qinfer_tpu_torch.ops import jacobi as jac
from qinfer_tpu_torch.ops import precession as prec
from qinfer_tpu_torch.ops import streaming_resample as sr
from qinfer_tpu_torch.resamplers import counting_multiplicities_from_u
from qinfer_tpu_torch.tomography import bases

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("n", [1, 3, 255, 257, 2049, 300_001])
@pytest.mark.parametrize("outcome", [0, 1])
def test_k1_kernel_matches_plain(_card, n, outcome):
    g = _gen(n)
    omega = torch.rand((n,), generator=g, device=_card)
    w = torch.rand((n,), generator=g, device=_card)
    before = prec.fused_precession_update.launches
    for t in (0.5, 40.0, 3.0e4):
        got = prec.fused_precession_update(omega, w, t, outcome)
        want = prec.fused_precession_update_plain(omega, w, t, outcome)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], rtol=0,
                                   atol=1e-6 * float(want[0].max()) + 1e-30)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-30)
    assert prec.fused_precession_update.launches == before + 3


def test_k1_kernel_reads_a_strided_column_and_is_deterministic(_card):
    g = _gen(5)
    locs = torch.rand((100_003, 3), generator=g, device=_card)
    w = torch.rand((100_003,), generator=g, device=_card)
    a = prec.fused_precession_update(locs[:, 2], w, 7.0, 1, normalize=False)
    b = prec.fused_precession_update(locs[:, 2], w, 7.0, 1, normalize=False)
    want = prec.fused_precession_update_plain(locs[:, 2].contiguous(), w,
                                              7.0, 1, normalize=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    torch.testing.assert_close(a[0], want[0], rtol=0, atol=1e-6)
    for x, y in zip(a[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-30)
    # the same column copied out (16-byte loads) gives the same h
    c = prec.fused_precession_update(locs[:, 2].contiguous(), w, 7.0, 1,
                                     normalize=False)
    assert torch.equal(c[0], a[0])


@pytest.mark.parametrize("n", [3, 2**22 + 5])
def test_k1_is_one_kernel_and_bit_identical_over_calls(_card, n):
    """The engine's call (normalize=False, t float32 and the outcome int32
    on the card) runs K1 alone: no cast, fill or epilogue kernels; and two
    calls agree to the bit in h and in all three sums."""
    from torch.profiler import ProfilerActivity, profile

    g = _gen(n)
    omega = torch.rand((n,), generator=g, device=_card)
    w = torch.rand((n,), generator=g, device=_card)
    t = torch.full((1,), 3.0e4, device=_card)
    outcome = torch.zeros((1,), dtype=torch.int32, device=_card)
    first = prec.fused_precession_update(omega, w, t, outcome,
                                         normalize=False)
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then sees no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            second = prec.fused_precession_update(omega, w, t, outcome,
                                                  normalize=False)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   for _ in range(e.count)
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1, kernels
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_k1_zero_weights_apply_the_clamps(_card):
    """Σh = 0: norm 0, the ESS and the mean through the 1e-35 floors, as
    the plain version's epilogue; normalized weights 0, not NaN."""
    omega = torch.rand((1000,), generator=_gen(11), device=_card)
    w = torch.zeros_like(omega)
    for normalize in (False, True):
        got = prec.fused_precession_update(omega, w, 2.0, 0,
                                           normalize=normalize)
        want = prec.fused_precession_update_plain(omega, w, 2.0, 0,
                                                  normalize=normalize)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        assert float(got[1]) == 0.0 and bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_k1_reads_the_outcome_in_its_dtype(_card, dtype):
    g = _gen(13)
    omega = torch.rand((4099,), generator=g, device=_card)
    w = torch.rand((4099,), generator=g, device=_card)
    for outcome in (0, 1):
        got = prec.fused_precession_update(
            omega, w, torch.tensor([40.0], device=_card),
            torch.tensor([outcome], dtype=dtype, device=_card))
        want = prec.fused_precession_update(omega, w, 40.0, outcome)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("n, n_e", [(1, 1), (1, 4), (5, 3), (4099, 1),
                                    (4099, 7)])
def test_k2_kernel_matches_plain(_card, n, n_e):
    g = _gen(n * n_e)
    omega = torch.rand((n,), generator=g, device=_card)
    ts = torch.rand((n_e,), generator=g, device=_card) * 1e3
    got = prec.precession_pr0(omega, ts)
    torch.testing.assert_close(got, prec.precession_pr0_plain(omega, ts),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n, d", [(1, 1), (7, 3), (1000, 1), (4097, 5),
                                  (65_539, 9), (1, 255), (4097, 255),
                                  (50_000, 255)])
def test_k3_kernel_is_bit_exact(_card, n, d):
    g = _gen(n + d)
    w = torch.rand((n,), generator=g, device=_card) ** 6 + 1e-12
    m, starts = counting_multiplicities_from_u(0.41, w, n)
    raw = torch.randint(-2**31, 2**31, (n, d), generator=g, device=_card,
                        dtype=torch.int64)
    x = raw.to(torch.int32).view(torch.float32)
    before = sr.streaming_resample_locations.launches
    got = sr.streaming_resample_locations(m, starts, x)
    want = sr.streaming_resample_locations_plain(m, starts, x)
    assert sr.streaming_resample_locations.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


COUNTING_SHAPES = [(2 ** 22,), (50_000,), (12, 131_072), (1000,), (1,)]


def _offsets(card, shape, seed):
    """One uniform offset a row: 0-d for one row, (T,) for T rows."""
    return torch.rand(shape[:-1], generator=_gen(seed), device=card)


@pytest.mark.parametrize("shape", COUNTING_SHAPES)
def test_counting_pass_equals_plain_on_dyadic_weights(_card, shape):
    """Small integers sum exactly in every order, so the chain and the
    plain version (cumsum and cummax) give the same counts to the bit;
    one chain a call."""
    g = _gen(shape[-1] + len(shape))
    w = torch.randint(0, 4, shape, generator=g, device=_card).float()
    w[..., -1] = 1.0
    u = _offsets(_card, shape, 3)
    before = cp.counting_multiplicities_from_u.launches
    got = cp.counting_multiplicities_from_u(u, w, shape[-1])
    assert cp.counting_multiplicities_from_u.launches == before + 1
    want = cp.counting_multiplicities_from_u_plain(u, w, shape[-1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("shape", COUNTING_SHAPES + [(3, 4097)])
def test_counting_pass_holds_its_invariants_and_its_model(_card, shape,
                                                          steep):
    """Random weights: the chain equals its NumPy model
    (``tests/test_torch_counting_pass.py``) to the bit; Σ m = n, m ≥ 0,
    the offsets are the exclusive sums of m, each ceiling within one slot
    of the float64 count; two calls agree to the bit, and a row of a
    batch gives what it gives alone."""
    import numpy as np
    from test_torch_counting_pass import chain_counts, float64_ceilings

    n = shape[-1]
    w = torch.rand(shape, generator=_gen(n + 1), device=_card)
    if steep:
        w = w ** 8 + 1e-12
    w = w / w.sum(dim=-1, keepdim=True)
    u = _offsets(_card, shape, n + 2)
    m, off = cp.counting_multiplicities_from_u(u, w, n)
    again = cp.counting_multiplicities_from_u(u, w, n)
    assert torch.equal(m, again[0]) and torch.equal(off, again[1])
    model = chain_counts(w.cpu().numpy(), u.cpu().numpy(), n)
    np.testing.assert_array_equal(m.cpu().numpy(), model[0])
    np.testing.assert_array_equal(off.cpu().numpy(), model[1])
    m2, off2 = m.reshape(-1, n), off.reshape(-1, n)
    assert torch.equal(m2.sum(dim=1, dtype=torch.int64),
                       torch.full((m2.shape[0],), n, device=_card))
    assert int(m2.min()) >= 0
    assert torch.equal(off2, torch.cumsum(m2, dim=1, dtype=torch.int32) - m2)
    upper = (off2 + m2).cpu().numpy()
    for t, (row, ut) in enumerate(zip(w.reshape(-1, n).cpu().numpy(),
                                      u.reshape(-1).cpu().numpy())):
        assert np.abs(upper[t] - float64_ceilings(row, ut, n)).max() <= 1
    if len(shape) == 2:
        alone = cp.counting_multiplicities_from_u(u[1], w[1].contiguous(), n)
        assert torch.equal(alone[0], m[1]) and torch.equal(alone[1], off[1])


@pytest.mark.parametrize("n", [2 ** 22, 131_072])
def test_counting_pass_keeps_the_last_slot_for_offsets_near_one(_card, n):
    """u = 1 − 2⁻²⁴ on the card, zeros at the end and one in the middle:
    the last slot goes to the last particle of positive weight and no
    zero weight gets a slot."""
    w = torch.ones((n,), device=_card)
    w[-100:] = 0.0
    w[n // 2] = 0.0
    w = w / w.sum()
    u = torch.full((), 1.0 - 2.0 ** -24, device=_card)
    m, _ = cp.counting_multiplicities_from_u(u, w, n)
    assert int(m.sum()) == n and int(m[w == 0].sum()) == 0
    assert int(m[n - 101]) >= 1


def test_counting_pass_refuses_what_the_chain_does_not_take(_card):
    w = torch.rand((3, 64), device=_card)
    with pytest.raises(ValueError):
        cp.counting_multiplicities_from_u(0.5, w.double(), 64)
    with pytest.raises(ValueError):
        cp.counting_multiplicities_from_u(0.5, w.t(), 3)
    with pytest.raises(ValueError):
        cp.counting_multiplicities_from_u(torch.rand(2, device=_card), w, 64)
    with pytest.raises(ValueError):
        cp.counting_multiplicities_from_u(0.5, w, 2 ** 24 + 1)
    with pytest.raises(ValueError):
        cp.counting_multiplicities_from_u(0.5, w[None], 64)


def test_liu_west_resample_runs_one_counting_chain_and_no_cummax(_card):
    """One Liu-West resample at 2²²: one counting chain, one K3 fill, and
    no ``torch.cummax`` (nor any other scan of PyTorch's) on the card."""
    from torch.profiler import ProfilerActivity, profile

    from qinfer_tpu_torch import SimplePrecessionModel
    from qinfer_tpu_torch.resamplers import LiuWestResampler

    n = 2 ** 22
    g = _gen(17)
    x = torch.rand((n, 1), generator=g, device=_card)
    w = torch.exp(-((x[:, 0] - 0.7) / 0.01) ** 2)
    w = w / w.sum()
    rs, model = LiuWestResampler(), SimplePrecessionModel()
    rs(model, g, w, x)
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then sees no device event
        before = (cp.counting_multiplicities_from_u.launches,
                  sr.streaming_resample_locations.launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rs(model, g, w, x)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert (cp.counting_multiplicities_from_u.launches,
            sr.streaming_resample_locations.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert any("counting_pass_counts" in k for k in kernels), kernels
    assert not any("cummax" in k or "scan" in k for k in kernels), kernels


def test_k3_point_mass_and_two_survivors(_card):
    n = 10_000
    for d in (2, 255):
        x = torch.randn((n, d), generator=_gen(d), device=_card)
        for hot in ([0], [n - 1], [3, n - 2]):
            w = torch.full((n,), 1e-30, device=_card)
            w[hot] = 1.0
            m, starts = counting_multiplicities_from_u(0.5, w, n)
            got = sr.streaming_resample_locations(m, starts, x)
            assert torch.equal(got, sr.streaming_resample_locations_plain(
                m, starts, x))


def test_wrappers_refuse_what_the_kernels_do_not_take(_card):
    omega = torch.rand((64,), device=_card)
    with pytest.raises(ValueError):
        prec.fused_precession_update(omega, omega.double(), 1.0, 0)
    with pytest.raises(ValueError):
        prec.fused_precession_update(omega, omega[:32], 1.0, 0)
    with pytest.raises(ValueError):
        prec.precession_pr0(omega, torch.ones((2, 2), device=_card))
    m = torch.ones((64,), dtype=torch.int32, device=_card)
    s = torch.arange(64, dtype=torch.int32, device=_card)
    x = torch.rand((2, 64), device=_card).T  # not contiguous
    with pytest.raises(ValueError):
        sr.streaming_resample_locations(m, s, x)
    with pytest.raises(ValueError):
        sr.streaming_resample_locations(m.long(), s, x.contiguous())


# -- K4-K6: the Jacobi kernels ------------------------------------------------
#
# The kernel rounds every step as the plain version's separate elementwise
# ops do (no FMA contraction), so the two agree to the bit: eigenvalues,
# eigenvectors and projections. Embedded inputs, whose eigenvalues come in
# exact pairs, take EMBEDDED_SWEEPS sweeps, as the tomography models run
# them.


def _symmetric(g, n, d, embedded=False):
    """Random symmetric matrices, or the embedding of random Hermitian
    ones (every eigenvalue twice) when ``embedded``."""
    if embedded:
        h = d // 2
        re = torch.randn((n, h, h), generator=g, device="cuda")
        im = torch.randn((n, h, h), generator=g, device="cuda")
        re, im = re + re.transpose(1, 2), im - im.transpose(1, 2)
        return bases.assemble_embedding(re, im).contiguous()
    a = torch.randn((n, d, d), generator=g, device="cuda")
    return (a + a.transpose(1, 2)).contiguous()


_JACOBI_SHAPES = [(n, d) for d in (4, 8, 16, 32)
                  for n in (1, 1023, 50_001)]


@pytest.mark.parametrize("n, d", _JACOBI_SHAPES)
def test_jacobi_eigh_kernel_matches_plain(_card, n, d):
    embedded = n % 2 == 1
    a = _symmetric(_gen(n + d), n, d, embedded=embedded)
    sweeps = bases.EMBEDDED_SWEEPS if embedded else 6
    before = jac.jacobi_eigh_lanes.launches
    ev, V = jac.jacobi_eigh_lanes(a, sweeps=sweeps)
    ev_p, V_p = jac.jacobi_eigh_lanes_plain(a, sweeps=sweeps)
    torch.cuda.synchronize()
    assert jac.jacobi_eigh_lanes.launches == before + 1
    scale = float(a.abs().max())
    assert torch.equal(ev, ev_p) and torch.equal(V, V_p)
    recon = (V * ev[:, None, :]) @ V.transpose(1, 2)
    assert float((recon - a).abs().max()) <= 2e-5 * scale * d / 8


@pytest.mark.parametrize("looped", [False, True])
@pytest.mark.parametrize("n, d", _JACOBI_SHAPES)
def test_jacobi_project_kernel_matches_plain(_card, n, d, looped):
    fn = (jac.jacobi_project_lanes_looped if looped
          else jac.jacobi_project_lanes)
    embedded = n % 2 == 0
    a = _symmetric(_gen(3 * n + d), n, d, embedded=embedded)
    sweeps = bases.EMBEDDED_SWEEPS if embedded else 6
    before = fn.launches
    got = fn(a, sweeps=sweeps, trace=2.0)
    want = jac.jacobi_project_lanes_plain(a, sweeps=sweeps, trace=2.0)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, got.transpose(1, 2))
    # rows with positive mass come out with trace 2 (a negative definite
    # random matrix projects to 0)
    ev, _ = jac.jacobi_eigh_lanes_plain(a, sweeps=sweeps)
    mass = torch.clamp_min(ev, 0.0).sum(-1) > 1e-3
    tr = torch.diagonal(got, dim1=1, dim2=2).sum(-1)[mass]
    torch.testing.assert_close(tr, torch.full_like(tr, 2.0), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("n", [1, 5, 37, 1023, 100_001])
@pytest.mark.parametrize("d", range(2, 17, 2))
def test_packed_kernels_equal_plain_at_every_even_d(_card, d, n):
    """K4 and K6 pack ⌊32/d⌋ matrices a warp; n ragged against every
    packing leaves a tail warp with empty segments."""
    for embedded, sweeps in ((False, 6), (True, bases.EMBEDDED_SWEEPS)):
        a = _symmetric(_gen(7 * n + d + embedded), n, d, embedded=embedded)
        ev, V = jac.jacobi_eigh_lanes(a, sweeps=sweeps)
        ev_p, V_p = jac.jacobi_eigh_lanes_plain(a, sweeps=sweeps)
        assert torch.equal(ev, ev_p) and torch.equal(V, V_p)
        got = jac.jacobi_project_lanes(a, sweeps=sweeps)
        assert torch.equal(got, jac.jacobi_project_lanes_plain(
            a, sweeps=sweeps))


@pytest.mark.parametrize("d", range(2, 33, 2))
def test_warp_projection_equals_plain_at_every_even_d(_card, d):
    """K5's warp kernel is instantiated for each even d; 37 matrices leave
    the last block with one warp of four."""
    for embedded, sweeps in ((False, 6), (True, bases.EMBEDDED_SWEEPS)):
        a = _symmetric(_gen(d + embedded), 37, d, embedded=embedded)
        got = jac.jacobi_project_lanes_looped(a, sweeps=sweeps)
        assert torch.equal(got, jac.jacobi_project_lanes_plain(
            a, sweeps=sweeps))


def test_jacobi_kernels_take_denormal_and_overflowing_pivots(_card):
    """|a_pq| below the 1e-30 guard (here a denormal) skips the rotation;
    just above it, theta² overflows to inf and t = 0: no NaN either way."""
    a = torch.zeros((4, 8, 8), device="cuda")
    a[:] = torch.diag(torch.arange(1.0, 9.0, device="cuda"))
    a[0, 0, 7] = a[0, 7, 0] = 1e-39  # denormal, under the guard
    a[1, 2, 5] = a[1, 5, 2] = 2e-30  # above the guard: theta ~ 7.5e29
    a[2, 1, 6] = a[2, 6, 1] = -3e-38
    a[3, 0, 1] = a[3, 1, 0] = 1e-3
    ev, V = jac.jacobi_eigh_lanes(a)
    ev_p, V_p = jac.jacobi_eigh_lanes_plain(a)
    out = jac.jacobi_project_lanes(a)
    looped = jac.jacobi_project_lanes_looped(a)
    torch.cuda.synchronize()
    for t in (ev, V, out, looped):
        assert bool(torch.isfinite(t).all())
    assert torch.equal(looped, jac.jacobi_project_lanes_plain(a))
    assert torch.equal(out, jac.jacobi_project_lanes_plain(a))
    assert torch.equal(ev, ev_p) and torch.equal(V, V_p)
    torch.testing.assert_close(ev[:3], torch.diagonal(a[:3], dim1=1, dim2=2),
                               rtol=0, atol=1e-6)


def test_batched_jacobi_eigh_small_pads_odd_d_on_the_card(_card):
    a = _symmetric(_gen(9), 777, 7)
    before = jac.jacobi_eigh_lanes.launches
    ev, V = bases.batched_jacobi_eigh_small(a)
    torch.cuda.synchronize()
    assert jac.jacobi_eigh_lanes.launches == before + 1
    assert ev.shape == (777, 7) and V.shape == (777, 7, 7)
    recon = (V * ev[:, None, :]) @ V.transpose(1, 2)
    assert float((recon - a).abs().max()) <= 2e-5 * float(a.abs().max())


def test_jacobi_wrappers_refuse_what_the_kernel_does_not_take(_card):
    for bad in (torch.zeros((4, 7, 7), device="cuda"),
                torch.zeros((4, 34, 34), device="cuda"),
                torch.zeros((4, 8, 8), device="cuda", dtype=torch.float64),
                torch.zeros((8, 8, 4), device="cuda").transpose(0, 2),
                torch.zeros((0, 8, 8), device="cuda")):
        with pytest.raises(ValueError):
            jac.jacobi_eigh_lanes(bad)
        with pytest.raises(ValueError):
            jac.jacobi_project_lanes_looped(bad)


# -- the resample-move slice on the card --------------------------------------
#
# No new kernel: the binomial pmf, the record likelihood and the moves are
# PyTorch ops. These tests hold the card's results to the CPU's on the
# same inputs (the draws made once on the CPU and fed to both), and check
# that the sweeps keep the adapted scale on the device.


def _binomial_grid():
    import numpy as np

    N = np.repeat(np.asarray([1, 16, 64, 1000, 10_000], np.float32), 400)
    rng = np.random.default_rng(0)
    n = np.floor(rng.random(N.size) * (N + 1)).astype(np.float32)
    p = rng.random(N.size).astype(np.float32)
    p[::9], p[::11], p[::13] = 0.0, 1.0, 1e-35
    return [torch.from_numpy(a) for a in (N, n, p)]


def test_log_binomial_pdf_on_the_card_matches_the_cpu(_card):
    from qinfer_tpu_torch.utils import log_binomial_pdf

    N, n, p = _binomial_grid()
    want = log_binomial_pdf(N, n, p)
    got = log_binomial_pdf(N.cuda(), n.cuda(), p.cuda()).cpu()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    ok = torch.isfinite(want)
    # lgamma to ~1 ulp of lgamma(N + 1) in each: 4 ulp of 8.2e4 at most
    ulp = 4 * torch.lgamma(N + 1.0).clamp_min(1.0) * 2.0 ** -23
    assert bool(((got - want).abs()[ok]
                 <= 1e-5 * want.abs()[ok] + ulp[ok]).all())


def _process_record(nq, n, seed):
    """A binomial record on the full (prep, meas) pool of ``nq``-qubit
    process tomography, with particles of the BCSZ prior drawn on the
    CPU: ``(model, prior, x, succ, trials, pool)``, all on the CPU."""
    import itertools
    from functools import reduce

    import numpy as np

    from qinfer_tpu_torch import BinomialModel
    from qinfer_tpu_torch import tomography as tomo

    b1, b2 = tomo.pauli_basis(nq), tomo.pauli_basis(2 * nq)
    model = BinomialModel(tomo.ProcessTomographyModel(b2, b1),
                          n_meas_max=64)
    prior = tomo.BCSZChoiDistribution(b2)
    x = prior.sample(torch.Generator().manual_seed(seed), n)
    kets1 = np.asarray([[1, 0], [0, 1], [2 ** -0.5, 2 ** -0.5],
                        [2 ** -0.5, 1j * 2 ** -0.5]], np.complex64)
    fid = torch.stack([b1.state_to_modelparams(np.outer(k, k.conj()))
                       for k in (reduce(np.kron, c) for c in
                                 itertools.product(kets1, repeat=nq))])
    f = fid.shape[0]
    pool = {"prep": fid.repeat_interleave(f, dim=0),
            "meas": fid.repeat(f, 1)}
    rng = np.random.default_rng(seed)
    trials = torch.tensor(rng.integers(0, 5, f * f) * 64, dtype=torch.int32)
    succ = torch.tensor((rng.random(f * f) * trials.numpy()).astype(
        np.int32))
    return model, prior, x, succ, trials, pool


def _to(d, dev):
    return {k: v.to(dev) for k, v in d.items()}


@pytest.mark.parametrize("nq, n", [(1, 20_000), (2, 5_000)])
def test_binomial_record_log_likelihood_on_the_card_matches_the_cpu(_card,
                                                                    nq, n):
    from qinfer_tpu_torch.rejuvenation import binomial_record_log_likelihood

    model, _, x, succ, trials, pool = _process_record(nq, n, 3)
    two = model.underlying_model
    want = binomial_record_log_likelihood(two, x, succ, trials, pool)
    got = binomial_record_log_likelihood(
        two, x.cuda(), succ.cuda(), trials.cuda(), _to(pool, "cuda")).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


class _FedDraws:
    """Stands in for the move kernels' draws: hands out pre-drawn normals
    and log-uniforms, moved to the device of the call, in order."""

    def __init__(self, seed):
        self.g = torch.Generator().manual_seed(seed)
        self.drawn, self.i = [], 0

    def replay(self):
        self.i = 0

    def _next(self, kind, shape, like):
        if self.i == len(self.drawn):
            self.drawn.append(torch.randn(shape, generator=self.g)
                              if kind == "normal" else
                              torch.log(torch.rand(shape, generator=self.g)))
        t = self.drawn[self.i]
        self.i += 1
        return t.to(device=like.device, dtype=like.dtype)

    def normal(self, generator, like, shape=None):
        return self._next("normal", like.shape if shape is None else shape,
                          like)

    def log_uniform(self, generator, like):
        return self._next("log_uniform", (like.shape[0],), like)


@pytest.mark.parametrize("method", ["rwm", "mala"])
def test_adaptive_move_on_the_card_matches_the_cpu(_card, method,
                                                   monkeypatch):
    from qinfer_tpu_torch import rejuvenation as rj

    model, prior, x, succ, trials, pool = _process_record(1, 4096, 5)
    draws = _FedDraws(7)
    monkeypatch.setattr(rj, "_normal", draws.normal)
    monkeypatch.setattr(rj, "_log_uniform", draws.log_uniform)
    ls0 = rj.initial_log_scale(x.shape[1], method)
    outs = {}
    for dev in ("cpu", "cuda"):
        draws.replay()
        outs[dev] = rj.mcmc_rejuvenate_binomial_adaptive(
            model, prior, None, x.to(dev), succ.to(dev), trials.to(dev),
            _to(pool, dev), 4, ls0, 0, method=method, canonicalize=False)
    (xc, ac, lc, tc), (xg, ag, lg, tg) = outs["cpu"], outs["cuda"]
    assert xg.is_cuda and lg.is_cuda and tg.is_cuda
    assert int(tg) == int(tc) == 4
    # an accept decision at a float boundary may flip: nearly every row
    # agrees to float32 tolerance, and the tallies follow
    same = ((xg.cpu() - xc).abs() <= 1e-4).all(dim=1).float().mean()
    assert float(same) > 0.99
    assert abs(float(ag) - float(ac)) < 0.01
    assert abs(float(lg) - float(lc)) < 0.01


def test_moves_without_canonicalize_leave_every_particle_valid(_card):
    """Two-qubit process tomography at 255 parameters: every accepted
    proposal passed ``are_models_valid``, so without the final projection
    the whole ensemble still passes."""
    from qinfer_tpu_torch import rejuvenation as rj

    model, prior, _, succ, trials, pool = _process_record(2, 8, 9)
    g = _gen(9)
    x = prior.sample(g, 20_000)
    assert bool(model.are_models_valid(x).all())
    x2, acc, ls, _ = rj.mcmc_rejuvenate_binomial_adaptive(
        model, prior, g, x, succ.cuda(), trials.cuda(), _to(pool, "cuda"),
        8, rj.initial_log_scale(255, "rwm"), 0, method="rwm",
        target_accept=0.14, canonicalize=False)
    assert 0.0 < float(acc) < 1.0 and not torch.equal(x2, x)
    assert bool(model.are_models_valid(x2).all())


def _coin_sweep_inputs(method):
    from qinfer_tpu_torch import BinomialModel, CoinModel, UniformDistribution
    from qinfer_tpu_torch import rejuvenation as rj

    model = BinomialModel(CoinModel(), n_meas_max=20)
    prior = UniformDistribution([[0.0, 1.0]])
    g = _gen(1)
    x = prior.sample(g, 8192)
    succ = torch.tensor([140], device="cuda")
    trials = torch.tensor([200], device="cuda")
    pool = {"exp_num": torch.zeros(1, dtype=torch.int32, device="cuda")}
    return rj, model, prior, g, x, succ, trials, pool


@pytest.mark.parametrize("method", ["rwm", "mala"])
def test_adaptive_sweeps_never_wait_for_the_card(_card, method):
    """The sweep loop reads nothing back: under ``set_sync_debug_mode
    ("error")`` the loop of a coin's adaptive move runs (its validity check
    is elementwise), and a whole move call makes as many synchronizing
    calls at 2 sweeps as at 12 (its one Cholesky check, its setup)."""
    import warnings

    rj, model, prior, g, x, succ, trials, pool = _coin_sweep_inputs(method)
    two = model.underlying_model
    log_pdf = rj.resolve_prior_log_pdf(prior)

    def posterior_lp(xx):
        return rj.binomial_record_log_likelihood(two, xx, succ, trials,
                                                 pool) + log_pdf(xx)

    chol = rj._ensemble_chol(x)
    cap = 20.0

    def lp_and_grad(xx):
        return rj._lp_and_whitened_grad(posterior_lp, xx, chol, cap)

    lp, u = lp_and_grad(x) if method == "mala" else (posterior_lp(x), None)
    ls = torch.tensor(rj.initial_log_scale(1, method), device="cuda")
    t = torch.zeros((), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rj._adaptive_sweeps(model, g, x, lp, u, chol, posterior_lp,
                                  lp_and_grad, 6, ls, t, method,
                                  rj.default_target_accept(method), True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out[2].is_cuda and int(out[3]) == 6

    def syncs(n_moves):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rj.mcmc_rejuvenate_binomial_adaptive(
                    model, prior, g, x, succ, trials, pool, n_moves, ls, t,
                    method=method)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(c.message) for c in caught)

    assert syncs(2) == syncs(12)


def test_binomial_accelerated_model_never_launches_k1(_card):
    """``BinomialModel(AcceleratedPrecessionModel)`` reweights by the
    log-binomial: an engine step launches K2 (its Pr(0)) and never K1,
    and its weights follow the same steps on the CPU. Tolerance: 1e-5 of
    the largest weight plus 1e-4 of each weight: the card's ``cosf`` and
    the CPU's ``cos`` may round Pr(0) an ulp apart, and a count of 16
    shots multiplies that in the log by up to n/p + (N − n)/(1 − p)."""
    from qinfer_tpu_torch import AcceleratedPrecessionModel, BinomialModel
    from qinfer_tpu_torch.resamplers import LiuWestResampler
    from qinfer_tpu_torch.smc import SMCState, _update_step

    model = BinomialModel(AcceleratedPrecessionModel(), n_meas_max=16)
    x = torch.rand((100_000, 1), generator=torch.Generator().manual_seed(3))
    states = {d: SMCState.initial(x.to(d)) for d in ("cpu", "cuda")}
    k1, k2 = (prec.fused_precession_update.launches,
              prec.precession_pr0.launches)
    for k, count in enumerate((11, 3, 16, 0, 9)):
        for d in states:
            states[d], _, _ = _update_step(
                model, LiuWestResampler(), states[d],
                torch.tensor([count], device=d),
                {"t": torch.tensor([0.5 + k], device=d),
                 "n_meas": torch.tensor([16], device=d)}, 0.5, 1e-10,
                torch.Generator(device=d), check_resample=False)
    torch.cuda.synchronize()
    assert prec.fused_precession_update.launches == k1
    assert prec.precession_pr0.launches == k2 + 5
    w_cpu, w_gpu = states["cpu"].weights, states["cuda"].weights.cpu()
    torch.testing.assert_close(w_gpu, w_cpu, rtol=1e-4,
                               atol=1e-5 * float(w_cpu.max()))


def test_k3_at_ten_million_particles_is_bit_exact(_card):
    """BASELINE config 5's resample fill: n = 10⁷ (no power of two), d = 1."""
    n = 10_000_000
    g = _gen(7)
    w = torch.rand((n,), generator=g, device=_card) ** 8 + 1e-12
    m, starts = counting_multiplicities_from_u(0.29, w / w.sum(), n)
    assert int(m.sum()) == n
    x = torch.rand((n, 1), generator=g, device=_card)
    got = sr.streaming_resample_locations(m, starts, x)
    want = sr.streaming_resample_locations_plain(m, starts, x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_design_scoring_and_selection_never_wait_for_the_card(_card):
    """Under ``set_sync_debug_mode("error")``: the information gain and
    Bayes risk of a masked binomial pool through the updater, chunked and
    not, every selection policy, and the flagship bench's pool scores and
    pick (two-qubit process, 256 pairs). The card's scores equal the
    CPU's on the same particles (rtol 1e-5, atol 2e-6: float32 reduction
    order)."""
    from qinfer_tpu_torch import (BinomialModel, SimplePrecessionModel,
                                  SMCUpdater, UniformDistribution)
    from qinfer_tpu_torch import tomography_bench as tb
    from qinfer_tpu_torch.expdesign import select_candidate

    model = BinomialModel(SimplePrecessionModel(), n_meas_max=8)
    ups = {d: SMCUpdater(model, 20_000, UniformDistribution([[0.0, 1.0]]),
                         seed=3, device=d) for d in ("cpu", "cuda")}
    ups["cuda"].state.locations.copy_(ups["cpu"].state.locations)
    gen = torch.Generator().manual_seed(1)
    eps = {"t": torch.rand((20,), generator=gen) * 30,
           "n_meas": torch.randint(1, 9, (20,), generator=gen,
                                   dtype=torch.int32)}
    eps_card = {k: v.to(_card) for k, v in eps.items()}
    cfg = tb.make_config("process", _card, 2,
                         design=tb.Design("egreedy", 0.25, 4))
    x = cfg.prior.sample(_gen(5), 4096)
    w = torch.full((4096,), 1.0 / 4096, device=_card)
    g = _gen(9)
    u = ups["cuda"]
    # warm-up: the models copy their constant tables to the card once
    u.expected_information_gain(eps_card)
    cfg.pool_scores(w, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [u.expected_information_gain(eps_card),
               u.expected_information_gain(eps_card, candidate_chunk=7),
               u.bayes_risk(eps_card), u.bayes_risk(eps_card,
                                                    candidate_chunk=7)]
        picks = [select_candidate(g, got[0], policy=p)
                 for p in ("greedy", "egreedy", "softmax", "auto")]
        scores = cfg.pool_scores(w, x)
        pool_eps, pool_idx = cfg.propose(g, 0, w, x, scores)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = ups["cpu"]
    want = [cpu.expected_information_gain(eps)] * 2 + [cpu.bayes_risk(eps)] * 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=2e-6)
    assert all(p.is_cuda and p.shape == () for p in picks)
    assert scores.shape == (256,) and bool(torch.isfinite(scores).all())
    assert pool_idx.is_cuda and pool_eps["prep"].shape == (1, 16)


def test_batch_update_is_the_update_loop_on_the_card(_card):
    """BASELINE configs 2 and 3 (``models_bench``'s record, one repeat) at
    20 000 particles: ``batch_update`` equals the loop of ``update`` calls
    to the bit on the card, and K3 fills every resample of the batch."""
    import warnings

    from qinfer_tpu_torch import ResamplerWarning, SMCUpdater
    from qinfer_tpu_torch.models_bench import make_configs

    k = 3
    for cfg in make_configs(1):
        a, b = (SMCUpdater(cfg.model, 20_000, cfg.prior, seed=3,
                           device=_card) for _ in range(2))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ResamplerWarning)
            sr.streaming_resample_locations.launches = 0
            a.batch_update(cfg.counts, cfg.eps, resample_interval=k)
            launches = sr.streaming_resample_locations.launches
            for i, c in enumerate(cfg.counts):
                b.update(int(c), {f: v[i:i + 1] for f, v in cfg.eps.items()},
                         check_for_resample=(i % k == k - 1))
        assert a.resample_count == b.resample_count >= 1
        assert launches == a.resample_count
        assert a.particle_weights.is_cuda
        assert torch.equal(a.particle_weights, b.particle_weights)
        assert torch.equal(a.particle_locations, b.particle_locations)
        assert a.normalization_record == b.normalization_record


@pytest.mark.parametrize("adaptive", [False, True])
def test_bcrb_on_the_card_is_finite_and_psd(_card, adaptive):
    """``SMCUpdaterBCRB`` on the Ramsey model at 50 000 particles: the
    per-particle autograd Fisher information runs on the card, and the
    accumulated information matrix is finite, symmetric and positive
    semidefinite, its pseudo-inverse finite."""
    from qinfer_tpu_torch import RamseyModel, SMCUpdaterBCRB
    from qinfer_tpu_torch import UniformDistribution

    u = SMCUpdaterBCRB(RamseyModel(), 50_000,
                       UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
                       adaptive=adaptive, device=_card)
    g = _gen(4)
    for j in range(16):
        t = 1.3 ** j
        o = int(torch.randint(0, 2, (), generator=g, device=_card))
        u.update(o, {"t": torch.full((1,), t, device=_card)})
    bim = u.current_bim
    assert bim.shape == (2, 2) and bim.dtype.name == "float64"
    assert bool(torch.isfinite(torch.as_tensor(bim)).all())
    assert abs(bim[0, 1] - bim[1, 0]) <= 1e-6 * abs(bim).max()
    ev = torch.linalg.eigvalsh(torch.as_tensor(bim))
    assert float(ev.min()) >= -1e-6 * float(ev.abs().max())
    assert bool(torch.isfinite(torch.as_tensor(u.current_bcrb)).all())


def _item8_draw(kind, g, dev):
    """One generator-driven draw of the item-8 samplers, on the card."""
    import qinfer_tpu_torch as qt
    from qinfer_tpu_torch.distributions import sample_beta, sample_gamma

    if kind == "gamma":
        return sample_gamma(g, 0.7, (20_000,))
    if kind == "beta":
        return sample_beta(g, 1.0, 9.0, (20_000,))
    if kind == "dirichlet":
        return qt.MVUniformDistribution(6).sample(g, 20_000)
    if kind == "poisson":
        m = qt.ReferencedPoissonModel(qt.SimplePrecessionModel())
        eps = {"t": torch.ones((3,), device=dev),
               "mode": torch.tensor([0, 1, 2], dtype=torch.int32,
                                    device=dev)}
        return m.simulate_experiment(
            g, torch.tensor([[0.7, 40.0, 2.0]], device=dev), eps,
            repeat=5000)
    if kind == "multinomial":
        m = qt.MultinomialModel(qt.NDieModel(6), n_meas_max=100)
        eps = {"exp_num": torch.zeros((2,), dtype=torch.int32, device=dev),
               "n_meas": torch.tensor([100, 37], dtype=torch.int32,
                                      device=dev)}
        p = torch.tensor([[0.1, 0.15, 0.2, 0.25, 0.05, 0.25]], device=dev)
        return m.simulate_experiment(g, p, eps, repeat=2000)
    return qt.sample_multinomial(g, 50, [0.2, 0.3, 0.5], (4000,))


@pytest.mark.parametrize("kind", ["gamma", "beta", "dirichlet", "poisson",
                                  "multinomial", "sample_multinomial"])
def test_item8_samplers_replay_from_a_cuda_generator(_card, kind):
    """Every generator-driven sampler of the item-8 path draws on the card
    from a CUDA generator: the same seed gives the same draws to the bit,
    another seed others; multinomial totals equal each experiment's
    n_meas."""
    a = _item8_draw(kind, _gen(11), _card)
    b = _item8_draw(kind, _gen(11), _card)
    c = _item8_draw(kind, _gen(12), _card)
    assert a.is_cuda and torch.equal(a, b) and not torch.equal(a, c)
    if kind == "multinomial":
        assert bool((a.sum(-1) == torch.tensor(
            [100, 37], dtype=torch.int32, device=_card)).all())
    if kind in ("gamma", "beta"):
        assert bool(torch.isfinite(a).all()) and bool((a > 0).all())


def test_item8_gadfli_projection_equals_plain_to_the_bit(_card):
    """Run (e)'s strict projection: GADFLI-prior two-qubit states at
    100 000 particles, pushed off the PSD cone as a Liu-West proposal
    pushes them (a = 0.98 around the ensemble mean, the ensemble
    covariance's Cholesky factor), embedded (8×8): K4 equals its plain
    twin to the bit, and projects the rows the strict gate flags."""
    from qinfer_tpu_torch.tomography import GADFLIDistribution, TomographyModel
    from qinfer_tpu_torch.tomography.models import (STRICT_PSD_TOL,
                                                    _cholesky_fails)
    from qinfer_tpu_torch.utils import weighted_moments

    basis = bases.pauli_basis(2)
    model = TomographyModel(basis)
    fid = torch.zeros((4, 4), dtype=torch.complex64)
    fid[0, 0] = 1.0
    g = _gen(8)
    x = GADFLIDistribution(basis, fid.numpy()).sample(g, 100_000)
    w = torch.full((x.shape[0],), 1.0 / x.shape[0], device=_card)
    mu, cov = weighted_moments(w, x)
    L = torch.linalg.cholesky(cov + 1e-10 * torch.eye(15, device=_card))
    h = (1 - 0.98 ** 2) ** 0.5
    prop = 0.98 * x + 0.02 * mu + h * torch.randn(
        x.shape, generator=g, device=_card) @ L.T
    m = model._embedded_states(prop)
    assert int(_cholesky_fails(m, STRICT_PSD_TOL).sum()) > 0
    before = jac.jacobi_project_lanes.launches
    got = jac.jacobi_project_lanes(m, sweeps=bases.EMBEDDED_SWEEPS,
                                   trace=2.0)
    want = jac.jacobi_project_lanes_plain(m, sweeps=bases.EMBEDDED_SWEEPS,
                                          trace=2.0)
    torch.cuda.synchronize()
    assert jac.jacobi_project_lanes.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("T, n, d", [(1, 4097, 1), (3, 131_072, 1),
                                     (5, 1000, 3), (2, 5000, 255)])
def test_batched_fill_is_one_launch_equal_to_plain_and_per_trial(_card, T,
                                                                 n, d):
    """The batched counting fill: ONE K3 launch over the T·n rows, equal
    to the plain twin on the same flat counts and to each trial's own K3
    fill of its rows, to the bit; every row's counts sum to n."""
    from qinfer_tpu_torch.resamplers import counting_locations_batch_from_u

    g = _gen(T * n + d)
    w = torch.rand((T, n), generator=g, device=_card) ** 8 + 1e-12
    w = w / w.sum(dim=1, keepdim=True)
    x = torch.randn((T, n, d), generator=g, device=_card)
    u = torch.rand((T,), generator=g, device=_card)
    before = sr.streaming_resample_locations.launches
    x_anc, m, starts = counting_locations_batch_from_u(u, w, x)
    assert sr.streaming_resample_locations.launches == before + 1
    assert torch.equal(m.reshape(T, n).sum(dim=1),
                       torch.full((T,), n, device=_card))
    plain = sr.streaming_resample_locations_plain(m, starts,
                                                  x.reshape(T * n, d))
    assert torch.equal(plain.view(torch.int32).reshape(T, n, d),
                       x_anc.view(torch.int32))
    for t in range(T):
        rows = slice(t * n, (t + 1) * n)
        alone = sr.streaming_resample_locations(
            m[rows].contiguous(), (starts[rows] - t * n).contiguous(),
            x[t].contiguous())
        assert torch.equal(alone.view(torch.int32),
                           x_anc[t].view(torch.int32))


def test_batched_trials_sync_once_a_gated_step(_card):
    """The batched trial engine copies to the host once on each step the
    interval gate allows (the trials that resample) and on no other step,
    beside the resamples' own syncs (the Cholesky check and the validity
    rounds): with interval 8 over 32 steps, at most 4 gated steps of
    syncs, each at most 1 + 1 + maxiter."""
    import warnings

    from qinfer_tpu_torch import SimplePrecessionModel, UniformDistribution
    from qinfer_tpu_torch.perf_testing import perf_test_scan_batch

    runner, seeds = perf_test_scan_batch(
        SimplePrecessionModel(), 4096, UniformDistribution([[0.0, 1.0]]),
        32, 4, resample_interval=8, return_runner=True, device=_card)
    runner(seeds)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runner(seeds)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    # the record's final .tolist() of the resample counts is one more
    assert len(syncs) <= 4 * (1 + 1 + 10) + 1


def test_trial_engine_on_the_card_converges_in_both_modes(_card):
    from qinfer_tpu_torch import (AcceleratedPrecessionModel,
                                  SimplePrecessionModel, UniformDistribution)
    from qinfer_tpu_torch.perf_testing import perf_test_scan_batch

    prior = UniformDistribution([[0.0, 1.0]])
    for model, mesh in ((SimplePrecessionModel(), None),
                        (SimplePrecessionModel(), [_card]),
                        (AcceleratedPrecessionModel(), None)):
        prec.fused_precession_update.launches = 0
        rec = perf_test_scan_batch(model, 4096, prior, 40, 4, seed=1,
                                   mesh=mesh, device=_card)
        assert float(rec["loss"][:, -1].median()) < 5e-2
        if isinstance(model, AcceleratedPrecessionModel):
            assert prec.fused_precession_update.launches == 4 * 40


def test_checkpoint_resume_on_the_card_is_bit_identical(_card, tmp_path):
    """Save, load into an updater of another seed, and both continue to
    the bit, with the moves' adapted scale (a CUDA generator's state
    round-trips through the archive)."""
    from qinfer_tpu_torch import (BinomialModel, SimplePrecessionModel,
                                  SMCUpdater, UniformDistribution)
    from qinfer_tpu_torch.checkpoint import load_updater, save_updater

    model = BinomialModel(SimplePrecessionModel(), n_meas_max=16)

    def make(seed):
        return SMCUpdater(model, 20_000, UniformDistribution([[0.0, 1.0]]),
                          seed=seed, n_mcmc_moves=2,
                          compress_mcmc_record=True, mcmc_adapt=True,
                          zero_weight_policy="reset", device=_card)

    g = _gen(3)
    ts = torch.rand((60,), generator=g, device=_card) * 10
    outs = torch.randint(0, 17, (60,), generator=g, device=_card).tolist()
    n16 = torch.tensor([16], dtype=torch.int32, device=_card)
    a = make(1)
    for i in range(30):
        a.update(outs[i], {"t": ts[i:i + 1], "n_meas": n16})
    save_updater(tmp_path / "a.npz", a)
    b = make(2)
    load_updater(tmp_path / "a.npz", b)
    for i in range(30, 60):
        for u in (a, b):
            u.update(outs[i], {"t": ts[i:i + 1], "n_meas": n16})
        assert torch.equal(a.particle_weights, b.particle_weights)
        assert torch.equal(a.particle_locations, b.particle_locations)
        assert a.resample_count == b.resample_count
        assert a._mcmc_log_scale == b._mcmc_log_scale
    assert a.resample_count > 0
    cpu = SMCUpdater(model, 100, UniformDistribution([[0.0, 1.0]]),
                     n_mcmc_moves=2, compress_mcmc_record=True,
                     mcmc_adapt=True, device="cpu")
    with pytest.raises(ValueError, match="cuda generator"):
        load_updater(tmp_path / "a.npz", cpu)


@pytest.mark.parametrize("n", [1, 4096, 131_072, 10_000_000])
def test_single_row_cumsum_is_reproducible_on_the_card(_card, n):
    """``utils.cumsum_last`` on one row (PGH's draws on the card, and
    the counting pass's plain version): the same bits on five calls,
    within 1e-6 of the total of the float64 cumsum; on (T, n) rows it is
    ``torch.cumsum`` to the bit."""
    from qinfer_tpu_torch.utils import cumsum_last

    w = torch.rand((n,), generator=_gen(n), device=_card)
    first = cumsum_last(w)
    for _ in range(4):
        assert torch.equal(cumsum_last(w), first)
    ref = torch.cumsum(w.double(), dim=0)
    assert float((first.double() - ref).abs().max()) <= 1e-6 * float(ref[-1])
    rows = w[: n - n % 2].reshape(2, -1) if n > 1 else w.reshape(1, 1)
    if rows.shape[0] > 1:
        assert torch.equal(cumsum_last(rows), torch.cumsum(rows, dim=-1))


def _sharded_cloud(card, n, seed):
    """Precession-like weights with their mass on a few of 8 shards."""
    g = _gen(seed)
    x = torch.rand((n, 1), generator=g, device=card)
    w = torch.exp(-((torch.arange(n, device=card) - 0.2 * n) / (0.1 * n))
                  ** 2) * torch.rand((n,), generator=g, device=card)
    return w / w.sum(), x


@pytest.mark.parametrize("exchange", ["ring", "butterfly"])
def test_two_level_fill_is_one_k3_launch_equal_to_plain(_card, exchange):
    """The two-level fill over 8 shards of one card: ONE K3 launch over
    every shard's rows, equal to the plain twin on the same counts and to
    each shard's own K3 fill, to the bit."""
    from qinfer_tpu_torch.parallel import ParticleMesh
    from qinfer_tpu_torch.parallel.resample import exchange_blocks
    from qinfer_tpu_torch.resamplers import counting_locations_batch_from_u

    mesh = ParticleMesh([_card] * 8)
    n = 8 * 65_536
    w, x = _sharded_cloud(_card, n, 4)
    g = _gen(5)
    u1 = torch.rand((), generator=g, device=_card)
    u2 = torch.rand((8,), generator=g, device=_card)
    recv_w, recv_x = exchange_blocks(mesh, u1, mesh.shard(w), mesh.shard(x),
                                     exchange)
    before = sr.streaming_resample_locations.launches
    x_anc, m, starts = counting_locations_batch_from_u(u2, recv_w, recv_x)
    assert sr.streaming_resample_locations.launches == before + 1
    flat = recv_x.reshape(n, 1)
    plain = sr.streaming_resample_locations_plain(m, starts, flat)
    torch.cuda.synchronize()
    assert torch.equal(plain.view(torch.int32),
                       x_anc.reshape(n, 1).view(torch.int32))
    rows = n // 8
    for s in range(8):
        part = slice(s * rows, (s + 1) * rows)
        alone = sr.streaming_resample_locations(
            m[part].contiguous(), (starts[part] - s * rows).contiguous(),
            recv_x[s].contiguous())
        assert torch.equal(alone.view(torch.int32),
                           x_anc[s].view(torch.int32))


def test_ring_equals_butterfly_on_the_card(_card):
    from qinfer_tpu_torch import SimplePrecessionModel
    from qinfer_tpu_torch.parallel import (DistributedLiuWestResampler,
                                           ParticleMesh)

    mesh = ParticleMesh([_card] * 8)
    w, x = _sharded_cloud(_card, 8 * 65_536, 6)
    outs = [DistributedLiuWestResampler(mesh, exchange=e)
            .call_with_diagnostics(SimplePrecessionModel(), _gen(7), w, x)
            for e in ("ring", "butterfly")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert abs(float(outs[0][1].mean()) - float(w @ x[:, 0])) < 0.01


def test_sharded_scan_equals_unsharded_on_the_card(_card):
    """The main path's model with the plain resampler: a run sharded over
    8 shards of the card equals the unsharded run to the bit."""
    from qinfer_tpu_torch import (AcceleratedPrecessionModel, ParticleMesh,
                                  UniformDistribution)
    from qinfer_tpu_torch.perf_testing import perf_test_scan

    mesh = ParticleMesh([_card] * 8)
    runs = [perf_test_scan(AcceleratedPrecessionModel(), 1 << 16,
                           UniformDistribution([[0.0, 1.0]]), 64,
                           true_mps=[[0.7]], seed=3, sharding=s,
                           device=None if s else _card)
            for s in (mesh.particle_sharding, None)]
    (a, ra), (b, rb) = runs
    assert a.sharding is not None and b.sharding is None
    assert a.resample_count == b.resample_count > 0
    assert torch.equal(a.particle_locations, b.particle_locations)
    assert torch.equal(ra["loss"], rb["loss"])


@pytest.mark.parametrize("exchange", ["ring", "butterfly"])
def test_distributed_resample_waits_for_the_card_twice(_card, exchange):
    """One two-level resample waits for the card twice, for its Cholesky
    verdict and its validity check: the exchange and the butterfly's
    schedule stay on the card. One plain Liu-West resample of the same
    ensemble waits as often or more (its one-row counting pass writes
    its last element from the host)."""
    import warnings

    from qinfer_tpu_torch import SimplePrecessionModel
    from qinfer_tpu_torch.parallel import (DistributedLiuWestResampler,
                                           ParticleMesh)
    from qinfer_tpu_torch.resamplers import LiuWestResampler

    class AllValid(SimplePrecessionModel):
        def are_models_valid(self, modelparams):
            return torch.ones(modelparams.shape[0], dtype=torch.bool,
                              device=modelparams.device)

        def canonicalize(self, modelparams):
            return modelparams

    w, x = _sharded_cloud(_card, 8 * 4096, 8)

    def syncs(rs):
        rs.call_with_diagnostics(AllValid(), _gen(1), w, x)  # warm-up
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rs.call_with_diagnostics(AllValid(), _gen(1), w, x)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(c.message) for c in caught)

    two_level = syncs(DistributedLiuWestResampler(
        ParticleMesh([_card] * 8), exchange=exchange))
    assert two_level == 2
    assert syncs(LiuWestResampler(canonicalize=False)) >= two_level


def test_tomography_model_warns_past_the_jacobi_gate_on_the_card(_card):
    import warnings

    from qinfer_tpu_torch import PerformanceWarning
    from qinfer_tpu_torch.tomography import TomographyModel, pauli_basis

    with pytest.warns(PerformanceWarning, match="embedded 64 > 32"):
        TomographyModel(pauli_basis(5))
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        TomographyModel(pauli_basis(4))


def _nccl_worker(tmp_path, world, *tasks):
    """One rank of the worker over NCCL (the ranks of a bigger world are
    never started); ``(returncode, stdout, stderr)``."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "qinfer_tpu_torch.parallel.worker", "--rank",
         "0", "--world", str(world), "--backend", "nccl", "--init-method",
         f"file://{tmp_path}/store", "--tasks", ",".join(tasks)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    return p.returncode, p.stdout, p.stderr


def test_one_rank_nccl_group_collectives_on_the_card(_card, tmp_path):
    """A one-rank NCCL group in this process: the mesh spans it on the
    card, its collectives equal the one-process mesh of one shard's, and
    they are timed by CUDA events, read once at the end."""
    from qinfer_tpu_torch.parallel import ParticleMesh, initialize_multihost
    from qinfer_tpu_torch.parallel.worker import fixed_blocks

    torch.cuda.set_device(_card)
    initialize_multihost(f"file://{tmp_path}/store", 1, 0, backend="nccl")
    try:
        mesh = ParticleMesh()
        assert mesh.spans_processes and mesh.backend == "nccl"
        assert mesh.device == _card
        assert mesh.collective_timer == "CUDA events on the current stream"
        one = ParticleMesh([_card])
        block = fixed_blocks(mesh)
        assert torch.equal(mesh.psum(block), one.psum(block))
        assert torch.equal(mesh.all_gather(block), one.all_gather(block))
        assert torch.equal(mesh.pmax(block), one.pmax(block))
        assert torch.equal(mesh.ppermute(block, 1), block)
        mesh.barrier()
        # psum and pmax each all-gather once; a shift by 0 is no exchange
        assert mesh.collective_calls == 4
        seconds = mesh.collective_seconds
        assert 0 < seconds < 10 and mesh.collective_seconds == seconds
        mesh.collective_seconds, mesh.collective_calls = 0.0, 0
        assert mesh.collective_seconds == 0.0
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_nccl_worker_runs_the_collectives_task(_card, tmp_path):
    import json

    rc, out, err = _nccl_worker(tmp_path, 1, "card", "collectives")
    assert rc == 0, err
    lines = {json.loads(ln[len("RESULT "):])["task"]: json.loads(
        ln[len("RESULT "):]) for ln in out.splitlines()
        if ln.startswith("RESULT ")}
    card = lines["card"]["local_card"]
    assert all(card[k] for k in ("name", "pci_bus_id", "uuid"))
    got = lines["collectives"]
    assert got["collective_timer"] == "CUDA events on the current stream"
    assert got["device"] == "cuda:0" and got["reloaded"]
    assert got["local_implicit_mesh"] == [1, True, "cuda:0"]


def test_nccl_refuses_more_ranks_than_cards_on_the_card(_card, tmp_path):
    cards = torch.cuda.device_count()
    rc, out, err = _nccl_worker(tmp_path, cards + 1, "collectives")
    assert rc != 0 and "RESULT" not in out
    assert (f"NCCL takes one card a rank: {cards + 1} ranks and {cards} "
            f"cards") in err


def test_recording_never_waits_for_the_card(_card):
    """Tracing adds no synchronizing call: an adaptive sweep loop runs
    under ``set_sync_debug_mode("error")`` while recording, and a resampling
    update step and a move call make as many synchronizing calls recording
    as not, with equal outputs. The spans' device times are CUDA events."""
    import contextlib
    import warnings

    from qinfer_tpu_torch import AcceleratedPrecessionModel, tracing
    from qinfer_tpu_torch.resamplers import LiuWestResampler
    from qinfer_tpu_torch.smc import SMCState, _update_step

    rj, model, prior, _, x, succ, trials, pool = _coin_sweep_inputs("rwm")
    two = model.underlying_model
    log_pdf = rj.resolve_prior_log_pdf(prior)

    def posterior_lp(xx):
        return rj.binomial_record_log_likelihood(two, xx, succ, trials,
                                                 pool) + log_pdf(xx)

    chol = rj._ensemble_chol(x)
    ls = torch.tensor(rj.initial_log_scale(1, "rwm"), device="cuda")
    t = torch.zeros((), dtype=torch.int32, device="cuda")
    lp = posterior_lp(x)
    tracing.reset()
    with tracing.recording(_card):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rj._adaptive_sweeps(model, _gen(2), x, lp, None, chol,
                                posterior_lp, None, 6, ls, t, "rwm", 0.234,
                                True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    snap = tracing.snapshot()
    assert snap["timer"] == "CUDA events on the current stream"
    assert snap["totals"]["moves.propose"][0] == 6
    assert snap["totals"]["moves.posterior"][1] > 0
    tracing.reset()

    omega = torch.rand((1 << 16, 1), generator=_gen(3), device="cuda")

    def calls(record):
        torch.cuda.synchronize()
        out = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with (tracing.recording(_card) if record
                  else contextlib.nullcontext()):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    st, _, _ = _update_step(
                        AcceleratedPrecessionModel(), LiuWestResampler(),
                        SMCState.initial(omega), torch.tensor([1],
                                                              device="cuda"),
                        {"t": torch.tensor([3.0], device="cuda")}, 1.0,
                        1e-10, _gen(4))
                    out += [st.weights, st.locations]
                    out += list(rj.mcmc_rejuvenate_binomial_adaptive(
                        model, prior, _gen(5), x, succ, trials, pool, 4, ls,
                        t, method="rwm"))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(c.message) for c in caught), out

    off, out_off = calls(False)
    on, out_on = calls(True)
    assert on == off
    for a, b in zip(out_off, out_on):
        assert torch.equal(a, b)
    reads = tracing.snapshot()["host_reads"]
    assert reads["update.read"] == 1 and reads["moves.chol_verdict"] == 1
    tracing.reset()
