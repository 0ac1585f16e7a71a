"""Parity of the port's Jacobi kernels K4-K6 (their plain PyTorch versions,
which is what a CPU tensor runs) against the JAX package on the same NumPy
inputs.

* Against the Pallas kernels in interpret mode, at the sizes the JAX
  package's own tests use (interpret mode stalls at a full d = 8 unroll
  and takes minutes at d = 32): K6 at (300, 4, 4) with 3 sweeps, K4 at
  (300, 4, 4) with 4 sweeps, K5 at (300, 8, 8) with 2 sweeps. Tolerance
  1e-5 absolute (2e-5 for K5, the JAX package's own bound between its
  two projection kernels): the TPU kernels rotate pair by pair, the port
  applies a round's commuting rotations column phase first, so the two
  differ in rounding only.
* Against ``tomography.bases.batched_jacobi_eigh_small``, the JAX
  package's non-TPU Jacobi with the same schedule, at d = 8 and 16 with
  6 sweeps: eigenvalues to 2e-5 and eigenvectors to 2e-4 of their sign-
  aligned columns (the JAX form applies GᵀAG as two matrix products; on
  well-separated random spectra the vectors agree to rounding).
* Against float64 NumPy: projections of embedded states pushed out of
  the cone at d = 8, 16, 32 with 8 sweeps within 3e-6, eigenvalues
  within 1.1e-5 / 2.5e-5 at d = 8 / 16 (the TPU kernels' measured
  accuracy).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qinfer_tpu.ops import jacobi as jax_jacobi
from qinfer_tpu.tomography import bases as jax_bases

from qinfer_tpu_torch.ops import jacobi
from qinfer_tpu_torch.tomography import bases


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small ops; with several test
    workers on one machine, torch's default of one thread per core
    oversubscribes the cores many times over. One thread keeps them fast."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_symmetric(seed, n, d):
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(n, d, d)).astype(np.float32)
    return (b + b.transpose(0, 2, 1)) / 2


def _embedded_pushed(seed, n, d):
    """Embedded (2k, 2k) Hermitian states pushed out of the PSD cone:
    Wishart-like states with a traceless perturbation, trace 1."""
    rng = np.random.default_rng(seed)
    k = d // 2
    g = rng.normal(size=(n, k, k)) + 1j * rng.normal(size=(n, k, k))
    rho = g @ g.conj().transpose(0, 2, 1)
    rho /= np.trace(rho, axis1=1, axis2=2)[:, None, None]
    h = rng.normal(size=(n, k, k)) + 1j * rng.normal(size=(n, k, k))
    h = (h + h.conj().transpose(0, 2, 1)) * 0.02 / k
    h -= np.trace(h, axis1=1, axis2=2)[:, None, None] * np.eye(k) / k
    rho = rho + h
    return np.block([[rho.real, -rho.imag],
                     [rho.imag, rho.real]]).astype(np.float32)


def _f64_projection(a, trace=2.0):
    ev, V = np.linalg.eigh(a.astype(np.float64))
    ev = np.clip(ev, 0.0, None)
    ev = trace * ev / np.clip(ev.sum(-1, keepdims=True), 1e-35, None)
    return np.einsum("nab,nb,ncb->nac", V, ev, V)


@pytest.mark.parametrize("d", [2, 4, 6, 8, 12, 16, 32])
def test_round_robin_schedule_matches_jax(d):
    want = jax_jacobi._round_robin_rounds(d)
    assert want == jax_bases._round_robin_rounds(d)
    assert jacobi.round_robin_rounds(d) == want


@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 16, 30, 32])
def test_warp_kernel_mates_match_the_jax_schedule(d):
    """K5's warp kernel pairs each lane's row with ``round_robin_mate``:
    every round, those mates are the JAX schedule's pairs."""
    for r, pairs in enumerate(jax_jacobi._round_robin_rounds(d)):
        want = {}
        for p, q in pairs:
            want[p], want[q] = q, p
        assert {row: jacobi.round_robin_mate(row, r, d)
                for row in range(d)} == want


def test_eigh_plain_matches_pallas_interpret():
    a = _random_symmetric(7, 300, 4)
    ev_j, V_j = jax_jacobi.jacobi_eigh_lanes(jnp.asarray(a), sweeps=3,
                                             interpret=True)
    ev, V = jacobi.jacobi_eigh_lanes(torch.from_numpy(a), sweeps=3)
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(V.numpy(), np.asarray(V_j), atol=1e-5,
                               rtol=0)


def test_project_plain_matches_pallas_interpret():
    a = _random_symmetric(2, 300, 4)
    want = np.asarray(jax_jacobi.jacobi_project_lanes(
        jnp.asarray(a), sweeps=4, interpret=True))
    got = jacobi.jacobi_project_lanes(torch.from_numpy(a), sweeps=4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.array_equal(got, got.transpose(0, 2, 1))


def test_looped_plain_matches_pallas_interpret():
    a = _random_symmetric(11, 300, 8)
    want = np.asarray(jax_jacobi.jacobi_project_lanes_looped(
        jnp.asarray(a), sweeps=2, interpret=True))
    got = jacobi.jacobi_project_lanes_looped(torch.from_numpy(a),
                                             sweeps=2).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.array_equal(got, got.transpose(0, 2, 1))


@pytest.mark.parametrize("d", [8, 16])
def test_eigh_plain_matches_jax_batched_jacobi(d):
    a = _random_symmetric(d, 200, d)
    ev_j, V_j = jax_bases.batched_jacobi_eigh_small(jnp.asarray(a))
    ev, V = bases.batched_jacobi_eigh_small(torch.from_numpy(a))
    ev_j, V_j, ev, V = map(np.asarray, (ev_j, V_j, ev, V))
    np.testing.assert_allclose(ev, ev_j, atol=2e-5, rtol=0)
    # columns are eigenvectors up to sign
    sign = np.sign(np.sum(V * V_j, axis=1, keepdims=True))
    np.testing.assert_allclose(V, V_j * sign, atol=2e-4, rtol=0)


@pytest.mark.parametrize("d", [8, 16, 32])
def test_projection_of_embedded_states_matches_float64(d):
    a = _embedded_pushed(d, 400 if d <= 16 else 100, d)
    fn = (jacobi.jacobi_project_lanes if d <= 16
          else jacobi.jacobi_project_lanes_looped)
    got = fn(torch.from_numpy(a), sweeps=bases.EMBEDDED_SWEEPS).numpy()
    assert np.abs(got - _f64_projection(a)).max() < 3e-6
    assert np.array_equal(got, got.transpose(0, 2, 1))
    np.testing.assert_allclose(np.trace(got, axis1=1, axis2=2), 2.0,
                               atol=1e-4)


@pytest.mark.parametrize("d, tol", [(8, 1.1e-5), (16, 2.5e-5)])
def test_eigenvalues_match_float64(d, tol):
    for a, sweeps in ((_random_symmetric(3 * d, 200, d), 6),
                      (_embedded_pushed(5 * d, 200, d),
                       bases.EMBEDDED_SWEEPS)):
        ev, V = jacobi.jacobi_eigh_lanes(torch.from_numpy(a), sweeps=sweeps)
        want = np.linalg.eigvalsh(a.astype(np.float64))
        assert np.abs(np.sort(ev.numpy(), -1) - want).max() < tol
        vtv = np.einsum("nab,nac->nbc", V.numpy(), V.numpy())
        assert np.abs(vtv - np.eye(d)).max() < 1e-5


def test_degenerate_embedded_spectrum_comes_in_exact_pairs():
    """An embedded Hermitian matrix has every eigenvalue twice; with a
    spectrum that is itself degenerate (a projector) the eigenvalues come
    out in pairs and the projection is the matrix itself."""
    k = 4
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(k, k))
                        + 1j * rng.normal(size=(k, k)))
    rho = q @ np.diag([0.5, 0.5, 0.0, 0.0]) @ q.conj().T
    a = np.block([[rho.real, -rho.imag],
                  [rho.imag, rho.real]]).astype(np.float32)[None]
    ev, _ = jacobi.jacobi_eigh_lanes(torch.from_numpy(a),
                                     sweeps=bases.EMBEDDED_SWEEPS)
    np.testing.assert_allclose(np.sort(ev.numpy()[0]),
                               [0, 0, 0, 0, 0.5, 0.5, 0.5, 0.5], atol=2e-6)
    # the embedded trace of a unit-trace state is 2
    out = jacobi.jacobi_project_lanes(torch.from_numpy(a),
                                      sweeps=bases.EMBEDDED_SWEEPS)
    np.testing.assert_allclose(out.numpy(), a, atol=2e-6)


@pytest.mark.parametrize("d", [3, 5, 7])
def test_odd_d_is_padded_like_jax(d):
    a = _random_symmetric(d, 200, d)
    ev_j, V_j = jax_bases.batched_jacobi_eigh_small(jnp.asarray(a))
    ev, V = bases.batched_jacobi_eigh_small(torch.from_numpy(a))
    assert ev.shape == (200, d) and V.shape == (200, d, d)
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), atol=2e-5,
                               rtol=0)
    recon = np.einsum("nab,nb,ncb->nac", V.numpy(), ev.numpy(), V.numpy())
    assert np.abs(recon - a).max() < 2e-5 * np.abs(a).max()


def test_pivot_guard_skips_tiny_pivots_without_nan():
    a = np.zeros((3, 4, 4), np.float32)
    a[:] = np.diag([1.0, 2.0, 3.0, 4.0])
    a[0, 0, 3] = a[0, 3, 0] = 1e-39       # denormal, under the guard
    a[1, 1, 2] = a[1, 2, 1] = 2e-30       # theta² overflows: t = 0
    a[2, 0, 1] = a[2, 1, 0] = 1e-3
    ev, V = jacobi.jacobi_eigh_lanes(torch.from_numpy(a))
    assert torch.isfinite(ev).all() and torch.isfinite(V).all()
    np.testing.assert_array_equal(ev.numpy()[:2], np.diagonal(a[:2], 0, 1, 2))
    np.testing.assert_array_equal(V.numpy()[:2], np.broadcast_to(
        np.eye(4, dtype=np.float32), (2, 4, 4)))


def test_wrappers_take_the_plain_route_on_cpu():
    a = torch.from_numpy(_random_symmetric(1, 16, 8))
    wrappers = (jacobi.jacobi_eigh_lanes, jacobi.jacobi_project_lanes,
                jacobi.jacobi_project_lanes_looped)
    before = [fn.launches for fn in wrappers]
    ev, V = jacobi.jacobi_eigh_lanes(a)
    ev_p, V_p = jacobi.jacobi_eigh_lanes_plain(a)
    assert torch.equal(ev, ev_p) and torch.equal(V, V_p)
    assert torch.equal(jacobi.jacobi_project_lanes(a),
                       jacobi.jacobi_project_lanes_plain(a))
    assert torch.equal(jacobi.jacobi_project_lanes_looped(a),
                       jacobi.jacobi_project_lanes_looped_plain(a))
    assert [fn.launches for fn in wrappers] == before
    with pytest.raises(ValueError):
        jacobi.jacobi_eigh_lanes(torch.zeros((2, 5, 5)))
    with pytest.raises(ValueError):
        jacobi.jacobi_project_lanes(torch.zeros((2, 4, 6)))
