"""Parity of the port's precession kernels K1/K2 (their plain PyTorch
versions, which is what a CPU tensor runs) and of
``AcceleratedPrecessionModel`` against the JAX package, on the same NumPy
inputs. The JAX Pallas kernels run in interpret mode on the CPU.

Tolerances: h to 1e-6 · max w and the pr0 table to 1e-6 absolute (libm's
float32 cos against XLA's differ by an ulp, measured ≤ 1.5e-7 here even
at ω·t/2 ≈ 1e5); the sums Σh, ESS and mean to rtol 1e-5 (float32
reduction order: XLA's lane-parallel partials against torch.sum).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qinfer_tpu.test_models import (
    SimplePrecessionModel as JaxSimplePrecessionModel)
from qinfer_tpu.ops.accelerated import (
    AcceleratedPrecessionModel as JaxAcceleratedPrecessionModel)
from qinfer_tpu.ops.precession import (
    fused_precession_update as jax_fused_update,
    precession_pr0 as jax_pr0,
)

from qinfer_tpu_torch.ops.accelerated import AcceleratedPrecessionModel
from qinfer_tpu_torch.ops.precession import (
    fused_precession_update,
    precession_pr0,
)
from qinfer_tpu_torch.test_models import SimplePrecessionModel

N = 4096
H_ATOL = 1e-6
SUM_RTOL = 1e-5


def _ensemble(seed, n=N):
    rng = np.random.default_rng(seed)
    omega = rng.random(n, dtype=np.float32)
    w = rng.random(n, dtype=np.float32)
    return omega, w / w.sum()


@pytest.mark.parametrize("outcome", [0, 1])
@pytest.mark.parametrize("t", [0.5, 7.0, 3.0e3, 2.0e5])
@pytest.mark.parametrize("normalize", [False, True])
def test_k1_plain_matches_jax(t, outcome, normalize):
    omega, w = _ensemble(int(t) + outcome)
    want = jax_fused_update(jnp.asarray(omega), jnp.asarray(w), t, outcome,
                            normalize=normalize)
    got = fused_precession_update(torch.from_numpy(omega),
                                  torch.from_numpy(w), t, outcome,
                                  normalize=normalize)
    # h's error is w · |Δℓ| (an ulp of cos² near 1 in ℓ = 1 − pr0), so the
    # normalized weights carry it divided by the norm
    scale = float(w.max()) / (float(want[1]) if normalize else 1.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=H_ATOL * scale)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=SUM_RTOL)


def test_k1_takes_strided_column_and_tensor_scalars():
    rng = np.random.default_rng(3)
    locs = rng.random((N, 3), dtype=np.float32)
    w = np.full(N, 1.0 / N, np.float32)
    got = fused_precession_update(
        torch.from_numpy(locs)[:, 1], torch.from_numpy(w),
        torch.tensor([2.5]), torch.tensor([1], dtype=torch.int32))
    want = jax_fused_update(jnp.asarray(locs[:, 1]), jnp.asarray(w), 2.5, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=H_ATOL * float(w.max() / want[1]))


@pytest.mark.parametrize("normalize", [False, True])
def test_k1_zero_weights_match_jax(normalize):
    """Σh = 0: norm 0, and the ESS, the mean and the normalized weights
    through the 1e-35 floors, exactly as the JAX epilogue."""
    omega, _ = _ensemble(17)
    w = np.zeros(N, np.float32)
    want = jax_fused_update(jnp.asarray(omega), jnp.asarray(w), 3.0, 0,
                            normalize=normalize)
    got = fused_precession_update(torch.from_numpy(omega),
                                  torch.from_numpy(w), 3.0, 0,
                                  normalize=normalize)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        assert float(a) == float(b)
    assert float(got[1]) == 0.0


@pytest.mark.parametrize("outcome", [0, 1])
def test_k1_takes_an_int64_outcome_tensor(outcome):
    omega, w = _ensemble(19 + outcome)
    want = jax_fused_update(jnp.asarray(omega), jnp.asarray(w), 11.0,
                            outcome)
    got = fused_precession_update(
        torch.from_numpy(omega), torch.from_numpy(w),
        torch.tensor([11.0]), torch.tensor([outcome], dtype=torch.int64))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=H_ATOL * float(w.max() / want[1]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=SUM_RTOL)


@pytest.mark.parametrize("t", [0.25, 9.0, 5.0e4])
def test_k2_plain_matches_jax(t):
    omega, _ = _ensemble(11)
    want = np.asarray(jax_pr0(jnp.asarray(omega), t))
    got = precession_pr0(torch.from_numpy(omega),
                         torch.tensor([t], dtype=torch.float32))
    assert got.shape == (N, 1)
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=0, atol=1e-6)


def test_accelerated_likelihood_matches_jax():
    omega, _ = _ensemble(5)
    ts = np.array([0.3, 4.0, 900.0], np.float32)
    outcomes = np.array([0, 1], np.int32)
    mps = omega[:, None]
    want = np.asarray(JaxAcceleratedPrecessionModel().likelihood(
        jnp.asarray(outcomes), jnp.asarray(mps), {"t": jnp.asarray(ts)}))
    got = AcceleratedPrecessionModel().likelihood(
        torch.from_numpy(outcomes), torch.from_numpy(mps),
        {"t": torch.from_numpy(ts)})
    assert got.shape == (2, N, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # and the plain model's table (a different float order: ω·t/2)
    plain = SimplePrecessionModel().likelihood(
        torch.from_numpy(outcomes), torch.from_numpy(mps),
        {"t": torch.from_numpy(ts)})
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("outcome", [0, 1])
def test_accelerated_fused_reweight_matches_jax(outcome):
    omega, w = _ensemble(8 + outcome)
    mps = omega[:, None]
    eps = {"t": np.array([13.0], np.float32)}
    want = JaxAcceleratedPrecessionModel().fused_reweight(
        jnp.asarray(w), jnp.asarray(mps), jnp.asarray([outcome]),
        {"t": jnp.asarray(eps["t"])})
    got = AcceleratedPrecessionModel().fused_reweight(
        torch.from_numpy(w), torch.from_numpy(mps),
        torch.tensor([outcome]), {"t": torch.from_numpy(eps["t"])})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=H_ATOL * float(w.max()))
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=SUM_RTOL)


def test_accelerated_any_n_uses_the_kernel_path():
    """The port has no n % 2048 fallback: an odd n goes through the same
    wrapper (plain version on the CPU) and matches the JAX model, which
    falls back to its plain likelihood at this n."""
    n = 1001
    omega, w = _ensemble(21, n)
    mps = omega[:, None]
    want = np.asarray(JaxAcceleratedPrecessionModel().likelihood(
        jnp.asarray([0, 1]), jnp.asarray(mps), {"t": jnp.asarray([3.0])}))
    got = AcceleratedPrecessionModel().likelihood(
        torch.tensor([0, 1]), torch.from_numpy(mps),
        {"t": torch.tensor([3.0])})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    hyp, norm = AcceleratedPrecessionModel().fused_reweight(
        torch.from_numpy(w), torch.from_numpy(mps), torch.tensor([1]),
        {"t": torch.tensor([3.0])})
    np.testing.assert_allclose(hyp.numpy(), w * want[1, :, 0], rtol=0,
                               atol=H_ATOL * float(w.max()))


def test_domains_match_jax():
    from qinfer_tpu.domains import IntegerDomain as JaxInt
    from qinfer_tpu.domains import RealDomain as JaxReal
    from qinfer_tpu_torch.domains import IntegerDomain, RealDomain

    pts = np.array([-1.0, 0.0, 0.5, 1.0, 2.0, 3.0], np.float32)
    for ours, theirs in ((IntegerDomain(0, 2), JaxInt(0, 2)),
                         (IntegerDomain(1), JaxInt(1)),
                         (RealDomain(0.0, 1.0), JaxReal(0.0, 1.0)),
                         (RealDomain(), JaxReal())):
        np.testing.assert_array_equal(
            ours.in_domain(torch.from_numpy(pts)).numpy(),
            np.asarray(theirs.in_domain(jnp.asarray(pts))))
        assert ours.is_finite == theirs.is_finite
        assert ours.n_members == theirs.n_members
    np.testing.assert_array_equal(IntegerDomain(0, 2).values,
                                  JaxInt(0, 2).values)
    assert SimplePrecessionModel().domain().n_members == 2


def test_expparams_forms_match_jax():
    """Dicts, structured arrays, bare values and the empty dict all become
    a dict of float32 tensors with a leading experiment axis."""
    jax_model = JaxSimplePrecessionModel()
    model = SimplePrecessionModel()
    structured = np.array([(0.5,), (2.0,)], dtype=[("t", "f8")])
    for eps in ({"t": [0.5, 2.0]}, structured, 3.0, {}):
        got = model.canonicalize_expparams(eps)
        want = jax_model.canonicalize_expparams(eps)
        assert set(got) == set(want) == {"t"}
        assert got["t"].dtype == torch.float32
        np.testing.assert_array_equal(got["t"].numpy(),
                                      np.asarray(want["t"]))
