"""Parity of the port's ancestor functions and of its batched Liu-West
resample.

Ancestors. The same float32 weights and the same uniform offset go to both
packages (the JAX offset is read from its key with
``jax.random.uniform``). Tolerance: at 1000 particles the indices are
equal; at 100 003 particles with steep weights the two float32 CDFs round
apart (JAX sums in float32, the port's CPU cumsum accumulates in double),
so a span boundary may move by ONE slot (the known boundary difference):
every particle's first slot and copy count differ by at most 1, and at
most 0.5 % of the slots change hands.

Batched resample. Each ensemble's counts and fill equal its own unbatched
counts and fill to the bit (the CPU cumsum is sequential along a row, so
a batched row and a 1-D call sum alike), the fill is ONE call of the K3
wrapper over every row, and the Liu-West output keeps each ensemble's
moments (the tolerance of ``tests/test_resamplers.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qinfer_tpu import resamplers as jr

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import resamplers as tr
from qinfer_tpu_torch.ops import streaming_resample as sr


def _weights(seed, n):
    rng = np.random.default_rng(seed)
    w = rng.random(n) ** 8 + 1e-12
    return (w / w.sum()).astype(np.float32), float(rng.random())


def _hold_one_slot(a, b, n):
    """Both index vectors are non-decreasing fills of n slots: each
    particle's span boundary differs by at most one slot, and at most
    0.5 % of slots change hands."""
    ma = np.bincount(a, minlength=n)
    mb = np.bincount(b, minlength=n)
    assert ma.sum() == mb.sum() == n
    assert np.abs(np.cumsum(ma) - np.cumsum(mb)).max() <= 1
    assert np.count_nonzero(a != b) <= 0.005 * n


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [1000, 100_003])
def test_counting_ancestors_match_jax(seed, n):
    w, u = _weights(seed, n)
    want = np.asarray(jr.counting_ancestors_from_u(
        jnp.float32(u), jnp.asarray(w), n))
    got = tr.counting_ancestors_from_u(
        torch.tensor(u, dtype=torch.float32), torch.from_numpy(w), n).numpy()
    assert got.dtype == np.int32 and np.all(np.diff(got) >= 0)
    if n == 1000:
        np.testing.assert_array_equal(got, want)
    else:
        _hold_one_slot(want, got, n)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [1000, 100_003])
def test_merge_rank_ancestors_match_jax(seed, n):
    w, _ = _weights(seed, n)
    key = jax.random.key(seed)
    u = float(jax.random.uniform(key, ()))
    want = np.asarray(jr.systematic_ancestors(key, jnp.asarray(w)))
    got = tr._systematic_ancestors_from_u(
        torch.tensor(u, dtype=torch.float32), torch.from_numpy(w), n).numpy()
    if n == 1000:
        np.testing.assert_array_equal(got, want)
    else:
        _hold_one_slot(want, got, n)


def test_generator_forms_draw_one_uniform_and_agree():
    """The generator forms draw ONE uniform and apply the explicit-offset
    form; the locations forms gather or fill at those ancestors."""
    w, _ = _weights(4, 5000)
    w = torch.from_numpy(w)
    x = torch.randn((5000, 3), generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(9)
    u = torch.rand((), generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(
        tr.systematic_ancestors_counting(g, w).numpy(),
        tr.counting_ancestors_from_u(u, w, 5000).numpy())
    anc = tr.systematic_ancestors(torch.Generator().manual_seed(9), w)
    np.testing.assert_array_equal(
        anc.numpy(), tr._systematic_ancestors_from_u(u, w, 5000).numpy())
    assert torch.equal(tr.systematic_resample_locations(
        torch.Generator().manual_seed(9), w, x), x[anc.long()])
    filled = tr.systematic_resample_locations_counting(
        torch.Generator().manual_seed(9), w, x)
    assert torch.equal(filled, x[tr.counting_ancestors_from_u(
        u, w, 5000).long()])
    assert tr.systematic_ancestors(g, w, n_out=77).shape == (77,)


def test_multinomial_ancestors_follow_the_weights_as_jax_does():
    """IID categorical draws: the counts of 4 categories over 200 000
    draws within 4 binomial sd of n·w, in both packages."""
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    n = 200_000
    got = tr.multinomial_ancestors(torch.Generator().manual_seed(0),
                                   torch.from_numpy(w), n).numpy()
    want = np.asarray(jr.multinomial_ancestors(jax.random.key(0),
                                               jnp.asarray(w), n))
    sd = np.sqrt(n * w * (1 - w))
    for a in (got, want):
        assert np.all(np.abs(np.bincount(a, minlength=4) - n * w) <= 4 * sd)


def _batch(seed, T=3, n=2000, d=2):
    g = torch.Generator().manual_seed(seed)
    w = torch.rand((T, n), generator=g) ** 8 + 1e-12
    w = w / w.sum(dim=1, keepdim=True)
    x = torch.randn((T, n, d), generator=g)
    return w, x


@pytest.mark.parametrize("seed", range(3))
def test_batched_counts_and_fill_equal_each_row_alone(seed):
    w, x = _batch(seed)
    T, n, _ = x.shape
    u = torch.rand((T,), generator=torch.Generator().manual_seed(seed))
    m, s = tr.counting_multiplicities_from_u(u, w, n)
    x_anc, m_flat, starts = tr.counting_locations_batch_from_u(u, w, x)
    assert torch.equal(m.reshape(-1), m_flat)
    for t in range(T):
        mt, st = tr.counting_multiplicities_from_u(u[t], w[t], n)
        assert torch.equal(m[t], mt) and torch.equal(s[t], st)
        assert int(mt.sum()) == n
        assert torch.equal(starts[t * n:(t + 1) * n], st + t * n)
        alone = tr.counting_locations_from_u(u[t], w[t], x[t].contiguous())
        assert torch.equal(x_anc[t].view(torch.int32),
                           alone.view(torch.int32))
    # the plain twin on the flat rows is the same fill
    flat = sr.streaming_resample_locations_plain(m_flat, starts,
                                                 x.reshape(T * n, -1))
    assert torch.equal(flat.reshape(x.shape), x_anc)


def test_batched_counts_keep_sum_n_on_steep_rows():
    """Rows of a single dominant weight, of underflowing weights and of
    uniform weights all keep Σ m = n and non-negative counts."""
    n = 4099
    w = torch.full((3, n), 1e-30)
    w[0, 17] = 1.0
    w[2] = 1.0 / n
    w = w / w.sum(dim=1, keepdim=True)
    m, s = tr.counting_multiplicities_from_u(
        torch.tensor([0.0, 0.5, 0.999999]), w, n)
    assert torch.equal(m.sum(dim=1), torch.full((3,), n))
    assert int(m.min()) >= 0 and int(s.min()) >= 0


def test_last_slot_is_kept_for_offsets_near_one():
    """float32 rounds n − u down to n − 1 for u within half an ulp of n
    below 1; the JAX package's counts then cover n − 1 slots, the port's
    cover n (the ceiling of every prefix that has reached the total is
    set exactly)."""
    n = 131_072
    w = np.full(n, 1.0 / n, np.float32)
    u = np.float32(0.999)
    m, _ = tr.counting_multiplicities_from_u(torch.tensor(u),
                                             torch.from_numpy(w), n)
    mj, _ = jr.counting_multiplicities_from_u(jnp.float32(u),
                                              jnp.asarray(w), n)
    assert int(m.sum()) == n
    assert int(np.asarray(mj).sum()) == n - 1


@pytest.mark.parametrize("n,u", [(131_072, 0.999), (131_072, 0.9999999),
                                 (1 << 22, 0.9)])
def test_rounded_last_slot_goes_to_a_particle_of_positive_weight(n, u):
    """Zero weights at the end of the ensemble (and one in its middle) and
    an offset where float32 rounds n − u down: the slot the rounding drops
    goes to the last particle of positive weight, no particle of zero
    weight gets a slot, every count is within one of n·w, and Σ m = n; in
    a batched row too."""
    w = np.full(n, 1.0, np.float32)
    w[-100:] = 0.0
    w[n // 2] = 0.0
    w /= w.sum()
    wt = torch.from_numpy(w)
    m, s = tr.counting_multiplicities_from_u(torch.tensor(np.float32(u)),
                                             wt, n)
    mb, sb = tr.counting_multiplicities_from_u(
        torch.tensor([np.float32(u)] * 2), torch.stack([wt, wt]), n)
    for mm in (m, mb[0], mb[1]):
        assert int(mm.sum()) == n
        assert int(mm[wt == 0].abs().sum()) == 0
        assert float((mm.double() - n * wt.double()).abs().max()) <= 1.0
    assert int(m[n - 101]) >= 1
    assert torch.equal(mb[0], m) and torch.equal(sb[1], s)


def test_batched_fill_is_one_kernel_call_and_refuses_too_many_rows(
        monkeypatch):
    calls = []

    def counted(m, starts, locations):
        calls.append(locations.shape)
        return sr.streaming_resample_locations_plain(m, starts, locations)

    monkeypatch.setattr(tr, "streaming_resample_locations", counted)
    w, x = _batch(1, T=5, n=300, d=3)
    rs = tr.LiuWestResampler()
    rs.call_batch_with_diagnostics(qt.SimplePrecessionModel(),
                                   torch.Generator().manual_seed(0), w,
                                   x[..., :1].abs().contiguous())
    assert calls == [(1500, 1)]
    monkeypatch.setattr(tr, "_K3_MAX_ROWS", 1499)
    with pytest.raises(ValueError, match="int32 output offsets"):
        tr.counting_locations_batch_from_u(torch.zeros(5), w, x)


class _Positive(qt.Model):
    """Two parameters, valid where the first is positive."""

    @property
    def n_modelparams(self):
        return 2

    def are_models_valid(self, mps):
        return mps[:, 0] > 0


def test_batched_liu_west_keeps_each_ensembles_moments():
    """Each ensemble's output mean and covariance within the Liu-West
    moment tolerance of ``tests/test_resamplers.py`` (mean 0.05, covariance
    0.1 of its scale) of the input's, uniform weights, and the replayed
    uniforms give the per-ensemble fill."""
    T, n = 4, 20_000
    g = torch.Generator().manual_seed(3)
    shift = torch.arange(T, dtype=torch.float32)[:, None, None]
    x = torch.randn((T, n, 2), generator=g) * 0.5 + 2.0 + shift
    w = torch.rand((T, n), generator=g)
    w = w / w.sum(dim=1, keepdim=True)
    state = torch.Generator().manual_seed(11).get_state()
    gen = torch.Generator()
    gen.set_state(state)
    rs = tr.LiuWestResampler(a=0.98)
    new_w, new_x, fb = rs.call_batch_with_diagnostics(_Positive(), gen, w, x)
    assert new_w.shape == (T, n) and new_x.shape == (T, n, 2)
    assert torch.allclose(new_w, torch.full((T, n), 1.0 / n))
    assert fb.shape == (T,) and fb.dtype == torch.int32
    for t in range(T):
        mu, cov = qt.weighted_moments(w[t], x[t])
        mu2, cov2 = qt.weighted_moments(new_w[t], new_x[t])
        assert float((mu - mu2).abs().max()) < 0.05
        assert float((cov - cov2).abs().max()) < 0.1 * float(cov.abs().max())
    replay = torch.Generator()
    replay.set_state(state)
    u = torch.rand((T,), generator=replay)
    x_anc, _, _ = tr.counting_locations_batch_from_u(u, w, x)
    for t in range(T):
        assert torch.equal(x_anc[t], tr.counting_locations_from_u(
            u[t], w[t], x[t].contiguous()))


def test_batched_liu_west_counts_fallbacks_per_ensemble():
    """An ensemble whose proposals are all invalid keeps its ancestors and
    counts every slot as a fallback; a free ensemble counts none."""

    class _SecondInvalid(qt.Model):
        @property
        def n_modelparams(self):
            return 1

        def are_models_valid(self, mps):
            valid = torch.ones(mps.shape[0], dtype=torch.bool)
            valid[mps.shape[0] // 2:] = False
            return valid

    n = 500
    x = torch.randn((2, n, 1), generator=torch.Generator().manual_seed(0))
    w = torch.full((2, n), 1.0 / n)
    rs = tr.LiuWestResampler(maxiter=3)
    _, new_x, fb = rs.call_batch_with_diagnostics(
        _SecondInvalid(), torch.Generator().manual_seed(1), w, x)
    assert fb.tolist() == [0, n]
    assert rs.redraw_rounds == [3]
    assert set(new_x[1, :, 0].tolist()) <= set(x[1, :, 0].tolist())


@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 131_072, 10_000_003])
def test_blocked_cumsum_is_the_cumsum(n):
    """The card's reproducible one-row scan (rows of 4096 plus the scan of
    their totals), run here on the CPU: float64 within 1e-12 of the total
    of ``torch.cumsum``, float32 within 1e-6 of it."""
    from qinfer_tpu_torch.utils import _blocked_cumsum

    x = torch.from_numpy(np.random.default_rng(n).random(n))
    ref = torch.cumsum(x, dim=0)
    got = _blocked_cumsum(x)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref[-1])
    got32 = _blocked_cumsum(x.float()).double()
    assert float((got32 - ref).abs().max()) <= 1e-6 * float(ref[-1])
