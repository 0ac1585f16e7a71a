"""The port's hand-written CUDA kernels against their plain PyTorch
versions ON THE CARD, at small and ragged shapes (chip_smoke.py checks the
main path's shapes). Every test here is marked ``cuda`` and skips without
a CUDA device. The module imports no JAX, so it runs on a machine that
has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

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
