"""The port's hand-written CUDA kernels against their plain PyTorch
versions ON THE CARD, at small and ragged shapes (chip_smoke.py checks the
main path's shapes). Every test here is marked ``cuda`` and skips without
a CUDA device. The module imports no JAX, so it runs on a machine that
has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from qinfer_tpu_torch.ops import precession as prec
from qinfer_tpu_torch.ops import streaming_resample as sr
from qinfer_tpu_torch.resamplers import counting_multiplicities_from_u

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
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], want[0], rtol=0, atol=1e-6)


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
                                  (65_539, 9)])
def test_k3_kernel_is_bit_exact(_card, n, d):
    g = _gen(n + d)
    w = torch.rand((n,), generator=g, device=_card) ** 6 + 1e-12
    m, starts = counting_multiplicities_from_u(0.41, w, n)
    raw = torch.randint(-2**31, 2**31, (n, d), generator=g, device=_card,
                        dtype=torch.int64)
    x = raw.to(torch.int32).view(torch.float32)
    got = sr.streaming_resample_locations(m, starts, x)
    want = sr.streaming_resample_locations_plain(m, starts, x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_k3_point_mass_and_two_survivors(_card):
    n = 10_000
    x = torch.randn((n, 2), generator=_gen(1), device=_card)
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
