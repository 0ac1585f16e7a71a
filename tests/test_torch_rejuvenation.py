"""The port's rejuvenation module (``qinfer_tpu_torch.rejuvenation``) against
the JAX package's.

Deterministic parts take the same NumPy inputs in both packages:

* record log-likelihoods (full and sufficient-statistic) over a coin,
  whose Pr(0) is the particle itself, and over one-qubit process
  tomography on carried BCSZ particles: rtol 1e-5 (float32 reduction
  order);
* the ensemble Cholesky factor: 1e-5 of its largest entry; where both
  packages' Cholesky fails on a rank-deficient ensemble, both fall back to
  the covariance's PSD square root, which agree to 5e-4 (the null
  direction's eigenvalue is rounding noise);
* the scale constants: equal; the Robbins-Monro gain: to one float32
  ulp (each library's pow rounds on its own);
* the MALA whitened gradient by autograd against ``jax.vjp``: rtol 1e-4
  (atol 1e-4 of the largest entry), on particles away from the clip edges
  of Pr(0).

The move kernels draw from different random streams (threefry, Philox),
so they are held to what both must reach, at the JAX tests' tolerances:
the analytic Beta posterior of a coin under a uniform prior
(``tests/test_rejuvenation.py``, ``tests/test_adaptive_mcmc.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats as st
import torch

import qinfer_tpu as q
import qinfer_tpu.tomography as jtomo
from qinfer_tpu import rejuvenation as jrj
from qinfer_tpu.utils import sqrtm_psd as jax_sqrtm_psd

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import rejuvenation as rj
from qinfer_tpu_torch import tomography as ttomo


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _fiducials(basis):
    kets = np.asarray([[1, 0], [0, 1],
                       [1 / np.sqrt(2), 1 / np.sqrt(2)],
                       [1 / np.sqrt(2), 1j / np.sqrt(2)]], np.complex64)
    return np.stack([np.asarray(basis.state_to_modelparams(
        np.outer(k, k.conj()))) for k in kets]).astype(np.float32)


def _record(kind, T=24, n=256, n_meas=16, seed=0):
    """A binomial record over a finite pool, in NumPy: ``(jax model, port
    model, particles, outcomes (T,), record eps, pool eps, succ, trials,
    mask)``. Coin: 3 pool rows (the coin's experiments differ only by a
    label); process: 8 (prep, meas) pairs, BCSZ particles of one JAX
    draw."""
    rng = np.random.default_rng(seed)
    if kind == "coin":
        jm = q.BinomialModel(q.CoinModel(), n_meas_max=n_meas)
        tm = qt.BinomialModel(qt.CoinModel(), n_meas_max=n_meas)
        pool = {"exp_num": np.arange(3, dtype=np.int32)}
        x = rng.random((n, 1), dtype=np.float32)
        x[:4, 0] = [0.0, 1.0, 1e-6, 1.0 - 1e-6]
    else:
        jm = q.BinomialModel(jtomo.ProcessTomographyModel(
            jtomo.pauli_basis(2), jtomo.pauli_basis(1)), n_meas_max=n_meas)
        tm = qt.BinomialModel(ttomo.ProcessTomographyModel(
            ttomo.pauli_basis(2), ttomo.pauli_basis(1)), n_meas_max=n_meas)
        fid = _fiducials(jtomo.pauli_basis(1))
        pairs = rng.integers(0, 4, (8, 2))
        pool = {"prep": fid[pairs[:, 0]], "meas": fid[pairs[:, 1]]}
        x = np.asarray(jtomo.BCSZChoiDistribution(
            jm.underlying_model.basis).sample(jax.random.key(seed), n))
    E = next(iter(pool.values())).shape[0]
    c = rng.integers(0, E, T)
    eps = {k: v[c] for k, v in pool.items()}
    eps["n_meas"] = np.full(T, n_meas, np.int32)
    outcomes = np.asarray(jm.simulate_experiment(
        jax.random.key(seed + 1), jnp.asarray(x[4:5]),
        {k: jnp.asarray(v) for k, v in eps.items()}))[0].astype(np.int32)
    succ = np.bincount(c, weights=outcomes, minlength=E).astype(np.int32)
    trials = np.bincount(c, minlength=E).astype(np.int32) * n_meas
    mask = np.ones(T, bool)
    mask[-3:] = False
    return jm, tm, x, outcomes, eps, pool, succ, trials, mask


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


@pytest.mark.parametrize("kind", ["coin", "process"])
def test_record_log_likelihoods_match_jax(kind):
    jm, tm, x, outcomes, eps, pool, succ, trials, mask = _record(kind)
    want = np.asarray(jax.jit(jrj.record_log_likelihood, static_argnums=0)(
        jm, jnp.asarray(x), jnp.asarray(outcomes), _j(eps),
        jnp.asarray(mask)))
    got = rj.record_log_likelihood(
        tm, torch.tensor(x), torch.tensor(outcomes), _t(eps),
        torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # the pool's totals (the mask's last steps left in: the compressed
    # record holds every committed step)
    want = np.asarray(jrj.binomial_record_log_likelihood(
        jm.underlying_model, jnp.asarray(x), jnp.asarray(succ),
        jnp.asarray(trials), _j(pool)))
    got = rj.binomial_record_log_likelihood(
        tm.underlying_model, torch.tensor(x), torch.tensor(succ),
        torch.tensor(trials), _t(pool)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_record_log_likelihood_groups_long_records():
    """A record longer than one chunk, two-outcome and linear (no log
    form): the grouped sum equals the step-by-step sum."""
    model = qt.CoinModel()
    rng = np.random.default_rng(5)
    T = 3 * rj._RECORD_CHUNK + 17
    outcomes = torch.tensor(rng.integers(0, 2, T))
    eps = {"exp_num": torch.zeros(T, dtype=torch.int32)}
    mask = torch.tensor(rng.random(T) < 0.8)
    x = torch.tensor(rng.random((64, 1), dtype=np.float32))
    got = rj.record_log_likelihood(model, x, outcomes, eps, mask)
    p = x[:, 0].double()
    ones = int((outcomes.bool() & mask).sum())
    zeros = int((~outcomes.bool() & mask).sum())
    want = zeros * torch.log(p) + ones * torch.log1p(-p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def _precession_record(T=24, n=256, n_meas=16, seed=0):
    """The port's version of ``tests/test_sufficient_record.py``'s record:
    a BinomialModel precession record over a 4-candidate pool."""
    model = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=n_meas)
    pool_t = np.asarray([0.5, 1.7, 3.1, 6.4], np.float32)
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, T)
    eps = {"t": torch.tensor(pool_t[c]),
           "n_meas": torch.full((T,), n_meas, dtype=torch.int32)}
    outcomes = model.simulate_experiment(_gen(seed + 1),
                                         torch.tensor([[0.43]]), eps)[0]
    succ = torch.tensor(np.bincount(c, weights=outcomes.numpy(),
                                    minlength=4).astype(np.int32))
    trials = torch.tensor(np.bincount(c, minlength=4).astype(np.int32)
                          * n_meas)
    x = qt.UniformDistribution([[0.0, 1.0]]).sample(_gen(seed + 2), n)
    return model, x, outcomes, eps, succ, trials, {"t": torch.tensor(pool_t)}


def test_compressed_ll_differs_by_constant():
    """Full-record and sufficient-statistic log-likelihoods differ by the
    same constant for every particle (the log-binomial coefficients),
    where no record step reaches the floors."""
    from scipy.special import gammaln

    model, x, outcomes, eps, succ, trials, pool = _precession_record()
    T = outcomes.shape[0]
    full = rj.record_log_likelihood(model, x, outcomes, eps,
                                    torch.ones(T, dtype=torch.bool))
    comp = rj.binomial_record_log_likelihood(model.underlying_model, x, succ,
                                             trials, pool)
    per_step = torch.stack([model.log_likelihood(
        outcomes[k:k + 1], x, {f: v[k:k + 1] for f, v in eps.items()})[
        0, :, 0] for k in range(T)]).numpy()
    ok = np.all(per_step > -80.0, axis=0)
    assert np.sum(ok) > 100
    diff = (full.double() - comp.double()).numpy()[ok]
    assert np.std(diff) < 1e-3
    o = outcomes.double().numpy()
    m = eps["n_meas"].double().numpy()
    const = np.sum(gammaln(m + 1) - gammaln(o + 1) - gammaln(m - o + 1))
    np.testing.assert_allclose(np.mean(diff), const, rtol=1e-3, atol=0.05)


def test_zero_trial_padding_contributes_nothing():
    model, x, _, _, succ, trials, pool = _precession_record()
    base = rj.binomial_record_log_likelihood(model.underlying_model, x, succ,
                                             trials, pool)
    pad = {"t": torch.cat([pool["t"], torch.zeros(4)])}
    zeros = torch.zeros(4, dtype=torch.int32)
    padded = rj.binomial_record_log_likelihood(
        model.underlying_model, x, torch.cat([succ, zeros]),
        torch.cat([trials, zeros]), pad)
    np.testing.assert_allclose(base.numpy(), padded.numpy(), rtol=1e-6,
                               atol=1e-3)


def test_boundary_particles_not_favored():
    """A particle whose Pr(0) rounds to 1 but which saw a failure scores no
    higher on the compressed record than on the full one (up to the
    record's constant)."""
    from scipy.special import gammaln

    model = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=4)
    x = torch.tensor([[1e-7], [0.43]])
    full = rj.record_log_likelihood(
        model, x, torch.tensor([3]),
        {"t": torch.tensor([3.0]), "n_meas": torch.tensor([4])},
        torch.ones(1, dtype=torch.bool)).double().numpy()
    comp = rj.binomial_record_log_likelihood(
        model.underlying_model, x, torch.tensor([3]), torch.tensor([4]),
        {"t": torch.tensor([3.0])}).double().numpy()
    const = float(gammaln(5) - gammaln(4) - gammaln(2))
    np.testing.assert_allclose(full[1] - comp[1], const, atol=1e-3)
    assert comp[0] - full[0] <= const + 1e-3


@pytest.mark.parametrize("weighted", [False, True])
def test_ensemble_chol_matches_jax(weighted):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5000, 6)) @ rng.normal(size=(6, 6))).astype(
        np.float32)
    w = rng.random(5000).astype(np.float32)
    w /= w.sum()
    want = np.asarray(jrj._ensemble_chol(
        jnp.asarray(x), jnp.asarray(w) if weighted else None))
    got = rj._ensemble_chol(torch.tensor(x),
                            torch.tensor(w) if weighted else None).numpy()
    assert np.allclose(np.triu(got, 1), 0.0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_ensemble_chol_falls_back_to_the_psd_root_like_jax():
    """A rank-2 ensemble in three coordinates: the float32 Cholesky of its
    covariance meets a pivot of rounding noise. Where it fails in both
    packages (a NaN factor in JAX, ``info ≠ 0`` in torch), both return
    the covariance's symmetric PSD square root, and agree."""
    def is_root(m):
        return not np.allclose(np.triu(m, 1), 0.0)

    jchol = jax.jit(jrj._ensemble_chol)
    both = 0
    for seed in range(40):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(500, 3)).astype(np.float32)
        x[:, 2] = x[:, 0] + x[:, 1]
        got = rj._ensemble_chol(torch.tensor(x)).numpy()
        want = np.asarray(jchol(jnp.asarray(x)))
        if not (is_root(got) and is_root(want)):
            continue
        both += 1
        xt = torch.tensor(x)
        xc = xt - xt.mean(dim=0)
        cov = xc.T @ xc / 500 + 1e-10 * torch.eye(3)
        np.testing.assert_array_equal(got, qt.sqrtm_psd(cov).numpy())
        np.testing.assert_allclose(got, got.T, atol=1e-6)
        np.testing.assert_allclose(got @ got.T, cov.numpy(), atol=1e-4)
        # the null direction's eigenvalue is rounding noise (either sign,
        # clipped to 1e-12 before its root), so the roots agree to ~1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
        np.testing.assert_allclose(
            got, np.asarray(jax_sqrtm_psd(jnp.asarray(cov.numpy()))),
            atol=5e-4)
    assert both >= 3


def test_scale_constants_match_jax():
    for method in ("rwm", "mala"):
        assert rj.default_target_accept(method) == \
            jrj.default_target_accept(method)
        for d in (1, 4, 15, 64, 255):
            assert rj.initial_log_scale(d, method) == \
                jrj.initial_log_scale(d, method)
            for ps in (1.0, 2.38, 5.0):
                assert rj.initial_log_scale(d, method, ps) == \
                    jrj.initial_log_scale(d, method, ps)
    # the gain to one float32 ulp: the libraries' pow may round apart
    t = np.arange(0, 400, dtype=np.int32)
    np.testing.assert_allclose(
        rj._rm_gain(torch.tensor(t)).numpy(),
        np.asarray(jrj._rm_gain(jnp.asarray(t))), rtol=1.2e-7, atol=0)
    for fn in (rj.default_target_accept, jrj.default_target_accept):
        with pytest.raises(ValueError, match="unknown MCMC method"):
            fn("hmc")
    for fn in (rj.initial_log_scale, jrj.initial_log_scale):
        with pytest.raises(ValueError, match="unknown MCMC method"):
            fn(4, "nuts")


def test_mala_whitened_gradient_matches_jax_vjp():
    """The whitened, clipped gradient of the compressed process target by
    autograd against ``jax.vjp`` with a ones cotangent (the JAX kernel's
    form), on the same particles and factor, away from Pr(0)'s clip
    edges."""
    jm, tm, x, _, _, pool, succ, trials, _ = _record("process", n=512)
    chol = np.asarray(jrj._ensemble_chol(jnp.asarray(x)))
    cap = 20.0 * np.sqrt(x.shape[1])
    jprior = jtomo.BCSZChoiDistribution(jm.underlying_model.basis)
    jlog_pdf = jrj.resolve_prior_log_pdf(jprior)

    def jlp(xx):
        return jrj.binomial_record_log_likelihood(
            jm.underlying_model, xx, jnp.asarray(succ), jnp.asarray(trials),
            _j(pool)) + jlog_pdf(xx)

    @jax.jit
    def jax_grad(xx, a):
        lp, pull = jax.vjp(jlp, xx)
        g = pull(jnp.ones_like(lp))[0]
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        u = g @ a
        norm = jnp.linalg.norm(u, axis=1, keepdims=True)
        return lp, u * jnp.minimum(1.0, cap / jnp.maximum(norm, 1e-30))

    lp, want = jax_grad(jnp.asarray(x), jnp.asarray(chol))
    want = np.asarray(want)

    tprior = ttomo.BCSZChoiDistribution(tm.underlying_model.basis)
    tlog_pdf = rj.resolve_prior_log_pdf(tprior)

    def tlp(xx):
        return rj.binomial_record_log_likelihood(
            tm.underlying_model, xx, torch.tensor(succ),
            torch.tensor(trials), _t(pool)) + tlog_pdf(xx)

    got_lp, got = rj._lp_and_whitened_grad(tlp, torch.tensor(x),
                                           torch.tensor(chol), cap)
    assert not got_lp.requires_grad and not got.requires_grad
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(lp), rtol=1e-5,
                               atol=1e-4)
    p0 = np.asarray(jm.underlying_model.likelihood(
        jnp.asarray([0]), jnp.asarray(x), _j(pool)))[0]
    inner = np.all((p0 > 1e-3) & (p0 < 1 - 1e-3), axis=1)
    assert inner.sum() > 100
    np.testing.assert_allclose(got.numpy()[inner], want[inner], rtol=1e-4,
                               atol=1e-4 * np.abs(want[inner]).max())


def test_prior_densities_match_jax():
    ranges = [[0.0, 2.0], [1.0, 3.0]]
    pts = np.asarray([[1.0, 2.0], [1.0, 5.0], [0.0, 3.0], [-0.1, 2.0]],
                     np.float32)
    want = np.asarray(q.UniformDistribution(ranges).log_pdf(pts))
    got = qt.UniformDistribution(ranges).log_pdf(torch.tensor(pts)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert qt.UniformDistribution(ranges).is_flat_on_support
    for nq, rank, flat in ((1, None, True), (1, 1, False), (2, None, True)):
        for tomo in (jtomo, ttomo):
            b = tomo.pauli_basis(nq)
            assert tomo.GinibreDistribution(b, rank=rank) \
                .is_flat_on_support == flat
    for tomo in (jtomo, ttomo):
        assert tomo.BCSZChoiDistribution(tomo.pauli_basis(2)) \
            .is_flat_on_support
        assert not tomo.BCSZChoiDistribution(tomo.pauli_basis(2), rank=2) \
            .is_flat_on_support
    fn = rj.resolve_prior_log_pdf(ttomo.GinibreDistribution(
        ttomo.pauli_basis(1)))
    out = fn(torch.zeros((5, 3)))
    assert out.shape == (5,) and bool((out == 0).all())


def test_resolve_prior_log_pdf_refuses_intractable_priors():
    class NoDensity(qt.Distribution):
        n_rvs = 1

    class BrokenDensity(qt.Distribution):
        n_rvs = 2

        def log_pdf(self, x):
            raise AttributeError("a factor has no log_pdf")

    with pytest.raises(ValueError, match="neither log_pdf nor"):
        rj.resolve_prior_log_pdf(NoDensity())
    with pytest.raises(ValueError, match="cannot be evaluated"):
        rj.resolve_prior_log_pdf(BrokenDensity())
    with pytest.raises(ValueError):
        rj.resolve_prior_log_pdf(ttomo.GinibreDistribution(
            ttomo.pauli_basis(1), rank=1))


# ---------------------------------------------------------------------------
# The kernels against the analytic Beta posterior of a coin
# ---------------------------------------------------------------------------

_BETA = st.beta(15, 7)  # uniform prior, 14 outcomes 0 and 6 outcomes 1


def _coin_record():
    outcomes = np.asarray([0] * 14 + [1] * 6, np.int32)
    eps = {"exp_num": np.zeros(20, np.int32)}
    return outcomes, eps, np.ones(20, bool)


def _start(start, n=4096):
    if start == "prior":
        return np.random.default_rng(0).random((n, 1), dtype=np.float32)
    return _BETA.rvs((n, 1), random_state=3).astype(np.float32)


def _fixed_moves(package, x0, n_moves):
    outcomes, eps, mask = _coin_record()
    if package == "jax":
        x, acc = jax.jit(jrj.mcmc_rejuvenate,
                         static_argnames=("n_moves",))(
            q.CoinModel(), q.UniformDistribution([[0.0, 1.0]]),
            jax.random.key(1), jnp.asarray(x0), jnp.asarray(outcomes),
            _j(eps), jnp.asarray(mask), n_moves=n_moves)
    else:
        x, acc = rj.mcmc_rejuvenate(
            qt.CoinModel(), qt.UniformDistribution([[0.0, 1.0]]), _gen(1),
            torch.tensor(x0), torch.tensor(outcomes), _t(eps),
            torch.tensor(mask), n_moves)
    return np.asarray(x)[:, 0], float(acc)


@pytest.mark.parametrize("package", ["torch", "jax"])
@pytest.mark.parametrize("start", ["prior", "posterior"])
def test_fixed_moves_reach_and_keep_the_beta_posterior(package, start):
    """From prior samples (40 sweeps) the kernel reaches Beta(15, 7); from
    exact posterior samples (20 sweeps) it keeps it."""
    xs, acc = _fixed_moves(package, _start(start),
                           40 if start == "prior" else 20)
    tol = 0.02 if start == "prior" else 0.015
    assert abs(xs.mean() - _BETA.mean()) < tol
    assert abs(xs.std() - _BETA.std()) < tol
    assert 0.05 < acc < 0.9


def _adaptive_moves(package, x0, n_moves, method):
    outcomes, eps, mask = _coin_record()
    ls0 = jrj.initial_log_scale(1, method)
    if package == "jax":
        out = jrj.mcmc_rejuvenate_adaptive_jit(
            q.CoinModel(), q.UniformDistribution([[0.0, 1.0]]),
            jax.random.key(1), jnp.asarray(x0), jnp.asarray(outcomes),
            _j(eps), jnp.asarray(mask), n_moves=n_moves, log_scale=ls0,
            adapt_t=0, method=method)
    else:
        out = rj.mcmc_rejuvenate_adaptive(
            qt.CoinModel(), qt.UniformDistribution([[0.0, 1.0]]), _gen(1),
            torch.tensor(x0), torch.tensor(outcomes), _t(eps),
            torch.tensor(mask), n_moves, ls0, 0, method=method)
    x, acc, ls, t = out
    return np.asarray(x)[:, 0], float(acc), float(ls), int(t)


@pytest.mark.parametrize("package", ["torch", "jax"])
@pytest.mark.parametrize("method", ["rwm", "mala"])
@pytest.mark.parametrize("start", ["prior", "posterior"])
def test_adaptive_moves_reach_and_keep_the_beta_posterior(package, method,
                                                          start):
    n_moves = 60 if start == "prior" else 30
    xs, acc, ls, t = _adaptive_moves(package, _start(start), n_moves,
                                     method)
    tol = 0.02 if start == "prior" else 0.015
    assert abs(xs.mean() - _BETA.mean()) < tol
    assert abs(xs.std() - _BETA.std()) < tol
    assert 0.05 < acc < 0.95
    assert t == n_moves and np.isfinite(ls)


def test_binomial_adaptive_mala_reaches_the_beta_posterior():
    """The compressed target (one pool row: 14 of 20) under MALA."""
    model = qt.BinomialModel(qt.CoinModel(), n_meas_max=20)
    x, acc, ls, t = rj.mcmc_rejuvenate_binomial_adaptive(
        model, qt.UniformDistribution([[0.0, 1.0]]), _gen(1),
        torch.tensor(_start("prior")), torch.tensor([14]),
        torch.tensor([20]), {"exp_num": torch.zeros(1, dtype=torch.int32)},
        60, rj.initial_log_scale(1, "mala"), 0, method="mala")
    xs = x.numpy()[:, 0]
    assert abs(xs.mean() - _BETA.mean()) < 0.02
    assert abs(xs.std() - _BETA.std()) < 0.02
    assert int(t) == 60 and ls.ndim == 0 and t.dtype == torch.int32


@pytest.mark.parametrize("package", ["torch", "jax"])
@pytest.mark.parametrize("method,ls0", [("rwm", 3.0), ("mala", -6.0)])
def test_robbins_monro_drives_acceptance_to_target(package, method, ls0):
    """From a bad initial scale (huge for RWM, tiny for MALA), six calls of
    40 sweeps bring the last call's acceptance within 0.12 of the
    target and move the scale by more than 0.5."""
    target = rj.default_target_accept(method)
    n = 2048
    x = st.beta(141, 61).rvs((n, 1), random_state=7).astype(np.float32)
    pool = {"exp_num": np.zeros(1, np.int32)}
    ls, t, accs = ls0, 0, []
    for i in range(6):
        if package == "jax":
            x, acc, ls, t = jrj.mcmc_rejuvenate_binomial_adaptive_jit(
                q.BinomialModel(q.CoinModel(), n_meas_max=20),
                q.UniformDistribution([[0.0, 1.0]]),
                jax.random.fold_in(jax.random.key(3), i), jnp.asarray(x),
                jnp.asarray([140]), jnp.asarray([200]), _j(pool),
                n_moves=40, log_scale=ls, adapt_t=t, method=method)
        else:
            x, acc, ls, t = rj.mcmc_rejuvenate_binomial_adaptive(
                qt.BinomialModel(qt.CoinModel(), n_meas_max=20),
                qt.UniformDistribution([[0.0, 1.0]]), _gen(3 + i),
                torch.as_tensor(np.asarray(x)), torch.tensor([140]),
                torch.tensor([200]), _t(pool), 40, ls, t, method=method)
        accs.append(float(acc))
    assert abs(accs[-1] - target) < 0.12, accs
    assert abs(float(ls) - ls0) > 0.5


@pytest.mark.parametrize("package", ["torch", "jax"])
@pytest.mark.parametrize("kernel,lw_seed", [("rwm", None), ("pcn", None),
                                            ("rwm", 0.98), ("pcn", 0.98)])
def test_waste_free_reaches_the_beta_posterior(package, kernel, lw_seed):
    """Waste-free resample-move from an importance-weighted prior ensemble
    (70 successes of 100): every chain state kept, uniform weights, the
    Beta(71, 31) posterior."""
    n = 4096
    x = np.random.default_rng(0).random((n, 1), dtype=np.float32)
    ll = 70 * np.log(x[:, 0].astype(np.float64)) + 30 * np.log1p(
        -x[:, 0].astype(np.float64))
    w = np.exp(ll - ll.max())
    w = (w / w.sum()).astype(np.float32)
    pool = {"exp_num": np.zeros(1, np.int32)}
    if package == "jax":
        w2, x2, acc = jrj.waste_free_rejuvenate_binomial_jit(
            q.BinomialModel(q.CoinModel(), n_meas_max=20),
            q.UniformDistribution([[0.0, 1.0]]), jax.random.key(7),
            jnp.asarray(w), jnp.asarray(x), jnp.asarray([70]),
            jnp.asarray([100]), _j(pool), n_stages=8, kernel=kernel,
            lw_seed_a=lw_seed, beta=0.5)
    else:
        w2, x2, acc = rj.waste_free_rejuvenate_binomial(
            qt.BinomialModel(qt.CoinModel(), n_meas_max=20),
            qt.UniformDistribution([[0.0, 1.0]]), _gen(7), torch.tensor(w),
            torch.tensor(x), torch.tensor([70]), torch.tensor([100]),
            _t(pool), 8, kernel=kernel, lw_seed_a=lw_seed, beta=0.5)
    assert tuple(x2.shape) == (n, 1)
    np.testing.assert_allclose(np.asarray(w2), 1.0 / n)
    assert 0.05 < float(acc) < 0.995
    ref = st.beta(71, 31)
    xs = np.asarray(x2)[:, 0]
    tol = 0.01 if (kernel, lw_seed) == ("rwm", None) else 0.012
    assert abs(xs.mean() - ref.mean()) < tol
    assert abs(xs.std() - ref.std()) < 0.012


def test_waste_free_full_record_and_validation():
    """The full-record waste-free form reaches the same posterior; a stage
    count that does not divide n, and an unknown kernel, are refused."""
    model = qt.CoinModel()
    prior = qt.UniformDistribution([[0.0, 1.0]])
    n = 4096
    x = torch.tensor(np.random.default_rng(0).random((n, 1),
                                                     dtype=np.float32))
    outcomes = torch.tensor([0] * 70 + [1] * 30)
    eps = {"exp_num": torch.zeros(100, dtype=torch.int32)}
    mask = torch.ones(100, dtype=torch.bool)
    ll = rj.record_log_likelihood(model, x, outcomes, eps, mask)
    w = torch.softmax(ll, 0)
    _, x2, _ = rj.waste_free_rejuvenate(model, prior, _gen(7), w, x,
                                        outcomes, eps, mask, 8)
    ref = st.beta(71, 31)
    assert abs(float(x2.mean()) - ref.mean()) < 0.01
    with pytest.raises(ValueError, match="divide"):
        rj.waste_free_rejuvenate(model, prior, _gen(0), w[:100] / w[:100]
                                 .sum(), x[:100], outcomes, eps, mask, 3)
    with pytest.raises(ValueError, match="kernel"):
        rj.waste_free_rejuvenate(model, prior, _gen(0), w, x, outcomes, eps,
                                 mask, 8, kernel="hmc")


def test_full_and_compressed_records_give_the_same_chain():
    """One generator seed, targets equal up to a constant: the same chain
    but for float-boundary accept flips."""
    model, x, outcomes, eps, succ, trials, pool = _precession_record()
    prior = qt.UniformDistribution([[0.0, 1.0]])
    T = outcomes.shape[0]
    x_full, acc_full = rj.mcmc_rejuvenate(
        model, prior, _gen(99), x, outcomes, eps,
        torch.ones(T, dtype=torch.bool), 4)
    x_comp, acc_comp = rj.mcmc_rejuvenate_binomial(
        model, prior, _gen(99), x, succ, trials, pool, 4)
    assert abs(float(acc_full) - float(acc_comp)) < 0.02
    match = np.mean(np.all(np.isclose(x_full.numpy(), x_comp.numpy(),
                                      atol=1e-5), axis=1))
    assert match > 0.99


def test_moves_without_canonicalize_stay_valid():
    """``canonicalize=False`` returns validity-gated locations only, the
    same chain as with the projection up to the projection's nudge."""
    b = ttomo.pauli_basis(1)
    model = ttomo.TomographyModel(b)
    prior = ttomo.GinibreDistribution(b)
    x = model.canonicalize(prior.sample(_gen(0), 512))
    pool = {"meas": torch.eye(4) * np.sqrt(2).astype(np.float32)}
    succ = torch.tensor([30, 10, 20, 5])
    trials = torch.tensor([50, 50, 50, 50])
    x_canon, acc1 = rj.mcmc_rejuvenate_binomial(
        model, prior, _gen(4), x, succ, trials, pool, 3)
    x_raw, acc2 = rj.mcmc_rejuvenate_binomial(
        model, prior, _gen(4), x, succ, trials, pool, 3, canonicalize=False)
    assert float(acc1) == float(acc2)
    assert bool(model.are_models_valid(x_raw).all())
    assert float((x_raw - x_canon).abs().max()) < 5e-2
