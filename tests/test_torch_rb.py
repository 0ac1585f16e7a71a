"""Parity of the port's differentiable models against the JAX package:
randomized benchmarking (plain and interleaved), Ramsey and MultiCosine
likelihoods, the score, the Fisher information and ``ScoreMixin``.

Both packages get the same NumPy inputs from a seed. Tolerances:

* likelihoods to rtol 1e-5, atol 1e-6 (float32 ``pow``, ``exp`` and
  ``cos`` of the two libraries differ by a few ulps);
* the autograd score and the Fisher information to rtol 2e-5 with atol
  2e-6 of the largest entry (the same ulps through the derivative: a
  score ∂ log L = ∂L / L scales them by 1/L); the Fisher information's
  relative tolerance also grows as 1e-5/√(min_o L) where a likelihood
  nears 0;
* ``ScoreMixin``'s central differences to 4 float32 ulps of the largest
  |log L| over 2h (each log is rounded once in each package, and the
  difference quotient divides that rounding by the 2e-5 step);
* the accelerated precession model's score to the plain model's with no
  difference at all (it differentiates the plain likelihood).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu.ops.accelerated import (
    AcceleratedPrecessionModel as JaxAcceleratedPrecessionModel)

import qinfer_tpu_torch as qt

F32_EPS = float(np.finfo(np.float32).eps)


def _points(name, n, rng):
    """Valid model parameters (n, d) for each model, float32."""
    u = rng.uniform
    if name in ("precession", "multicos"):
        d = 1 if name == "precession" else 3
        return u(0.1, 1.0, (n, d)).astype(np.float32)
    if name == "coin":
        return u(0.05, 0.95, (n, 1)).astype(np.float32)
    if name == "ramsey":
        return np.stack([u(0.2, 1.0, n), u(0.01, 0.4, n)], 1).astype(
            np.float32)
    ps = u(0.8, 0.999, (n, 2 if name == "rb_interleaved" else 1))
    A = u(0.2, 0.5, (n, 1))
    B = u(0.1, 0.45, (n, 1))
    return np.concatenate([ps, A, B], 1).astype(np.float32)


def _experiments(name, n_e, rng):
    if name in ("precession", "multicos", "ramsey"):
        return {"t": rng.uniform(0.5, 20.0, n_e).astype(np.float32)}
    if name == "coin":
        return {"exp_num": np.arange(n_e, dtype=np.int32)}
    eps = {"m": rng.integers(1, 200, n_e).astype(np.int32)}
    if name == "rb_interleaved":
        eps["reference"] = (np.arange(n_e) % 2).astype(np.int32)
    return eps


def _models(name):
    """(JAX model, port model)."""
    return {
        "precession": (q.SimplePrecessionModel(), qt.SimplePrecessionModel()),
        "coin": (q.CoinModel(), qt.CoinModel()),
        "multicos": (q.MultiCosineModel(n_terms=3),
                     qt.MultiCosineModel(n_terms=3)),
        "ramsey": (q.RamseyModel(), qt.RamseyModel()),
        "rb": (q.RandomizedBenchmarkingModel(),
               qt.RandomizedBenchmarkingModel()),
        "rb_interleaved": (q.RandomizedBenchmarkingModel(interleaved=True),
                           qt.RandomizedBenchmarkingModel(interleaved=True)),
    }[name]


MODELS = ["precession", "coin", "multicos", "ramsey", "rb", "rb_interleaved"]


def _inputs(name, seed=0, n=257, n_e=7):
    rng = np.random.default_rng(seed)
    x = _points(name, n, rng)
    eps = _experiments(name, n_e, rng)
    return (x, eps, {k: jnp.asarray(v) for k, v in eps.items()},
            {k: torch.as_tensor(v) for k, v in eps.items()})


@pytest.mark.parametrize("name", MODELS)
def test_likelihood_matches_jax(name):
    jm, tm = _models(name)
    x, _, je, te = _inputs(name)
    want = np.asarray(jm.likelihood(jnp.array([0, 1]), jnp.asarray(x), je))
    got = tm.likelihood(torch.tensor([0, 1]), torch.as_tensor(x), te)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["multicos", "ramsey", "rb",
                                  "rb_interleaved"])
def test_validity_and_canonicalize_match_jax(name):
    """Validity on points inside and outside the constraints, and the
    canonical form (MultiCosine sorts its frequencies)."""
    jm, tm = _models(name)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.2, 1.1, (500, tm.n_modelparams)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.are_models_valid(torch.as_tensor(x)).numpy(),
        np.asarray(jm.are_models_valid(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tm.canonicalize(torch.as_tensor(x)).numpy(),
        np.asarray(jm.canonicalize(jnp.asarray(x))))


def test_interleaved_rb_picks_p_by_the_reference_field():
    """Pr(0) = A·p^m + B with p_ref where ``reference`` is 1 and p̃ where
    it is 0, clipped to [0, 1]."""
    m = qt.RandomizedBenchmarkingModel(interleaved=True)
    x = torch.tensor([[0.9, 0.5, 0.4, 0.5], [1.0, 1.0, 0.7, 0.6]])
    eps = {"m": torch.tensor([3, 3]), "reference": torch.tensor([0, 1])}
    L = m.likelihood(torch.tensor([0]), x, eps)[0]
    want = torch.tensor([[0.4 * 0.9 ** 3 + 0.5, 0.4 * 0.5 ** 3 + 0.5],
                         [1.0, 1.0]])
    torch.testing.assert_close(L, want)
    assert m.modelparam_names == ["p_tilde", "p_ref", "A", "B"]


def test_fidelity_conversions_match_jax():
    p = np.linspace(0.0, 1.0, 11)
    for d in (2, 4):
        np.testing.assert_allclose(qt.p_to_F(p, d), q.p_to_F(p, d))
        np.testing.assert_allclose(qt.F_to_p(qt.p_to_F(p, d), d), p,
                                   atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_score_matches_jax_jacrev(name):
    """The per-particle autograd score against the JAX package's
    ``vmap(jacrev)``: (d, n_outcomes, n_models, n_expparams)."""
    jm, tm = _models(name)
    x, _, je, te = _inputs(name, seed=1)
    want = np.asarray(jm.score(jnp.array([0, 1]), jnp.asarray(x), je))
    got = tm.score(torch.tensor([0, 1]), torch.as_tensor(x), te).numpy()
    assert got.shape == want.shape == (tm.n_modelparams, 2, x.shape[0], 7)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", MODELS)
def test_fisher_information_matches_jax(name):
    jm, tm = _models(name)
    x, _, je, te = _inputs(name, seed=2)
    want = np.asarray(jm.fisher_information(jnp.asarray(x), je))
    got = tm.fisher_information(torch.as_tensor(x), te).numpy()
    d = tm.n_modelparams
    assert got.shape == want.shape == (d, d, x.shape[0], 7)
    # Σ_o (∂L)²/L amplifies the likelihood's rounding by ~1/√L where an
    # outcome's L nears 0 (cos² at a node): the relative tolerance grows
    # from 2e-5 as 1e-5/√(min_o L)
    L_min = np.asarray(jm.likelihood(jnp.array([0, 1]), jnp.asarray(x),
                                     je)).min(axis=0)
    rtol = 2e-5 + 1e-5 / np.sqrt(np.clip(L_min, 1e-30, None))
    err = np.abs(got - want)
    assert np.all(err <= rtol * np.abs(want) + 2e-6 * np.abs(want).max()), (
        float(err.max()))
    # symmetric (to float32 rounding of the two einsum orders) and
    # positive semidefinite per (model, experiment)
    mats = np.moveaxis(got, (0, 1), (-2, -1)).astype(np.float64)
    np.testing.assert_allclose(mats, np.swapaxes(mats, -1, -2), rtol=1e-6,
                               atol=1e-6 * np.abs(mats).max())
    assert np.linalg.eigvalsh(mats).min() >= -1e-4 * np.abs(mats).max()


@pytest.mark.parametrize("name", ["ramsey", "rb"])
def test_score_mixin_matches_jax(name):
    """Central differences with h = 1e-5 in both packages."""
    jm, tm = _models(name)

    class JaxFD(q.ScoreMixin, type(jm)):
        pass

    class TorchFD(qt.ScoreMixin, type(tm)):
        pass

    x, _, je, te = _inputs(name, seed=3)
    want = np.asarray(JaxFD().score(jnp.array([0, 1]), jnp.asarray(x), je))
    got, L = TorchFD().score(torch.tensor([0, 1]), torch.as_tensor(x), te,
                             return_L=True)
    assert got.shape == want.shape
    max_log = float(torch.log(torch.clamp_min(L, qt.EPS)).abs().max())
    tol = 4 * F32_EPS * max(max_log, 1.0) / (2 * TorchFD._h)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # and near the autograd score where the likelihood is not tiny
    auto = tm.score(torch.tensor([0, 1]), torch.as_tensor(x), te)
    safe = L > 0.05
    assert float((got - auto)[:, safe].abs().max()) < 0.05 * float(
        auto.abs().max())


def test_accelerated_score_is_the_plain_score():
    """K2 has no autograd rule: the accelerated model differentiates the
    plain likelihood, as the JAX package's does (difference 0.0 there)."""
    x, _, je, te = _inputs("precession", seed=4, n=2048)
    plain = qt.SimplePrecessionModel().score(torch.tensor([0, 1]),
                                             torch.as_tensor(x), te)
    acc = qt.AcceleratedPrecessionModel().score(torch.tensor([0, 1]),
                                                torch.as_tensor(x), te)
    assert torch.equal(acc, plain)
    jax_acc = np.asarray(JaxAcceleratedPrecessionModel().score(
        jnp.array([0, 1]), jnp.asarray(x), je))
    jax_plain = np.asarray(q.SimplePrecessionModel().score(
        jnp.array([0, 1]), jnp.asarray(x), je))
    assert np.array_equal(jax_acc, jax_plain)
    torch.testing.assert_close(
        qt.AcceleratedPrecessionModel().fisher_information(
            torch.as_tensor(x), te),
        qt.SimplePrecessionModel().fisher_information(torch.as_tensor(x), te),
        rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_models_are_differentiable_as_in_jax(name):
    jm, tm = _models(name)
    assert isinstance(jm, q.DifferentiableModel)
    assert isinstance(tm, qt.DifferentiableModel)
    assert tm.modelparam_names == jm.modelparam_names
    assert [f[0] for f in tm.expparams_dtype] == [
        f[0] for f in jm.expparams_dtype]
