"""Parity of the port's K4 and K6 (their plain PyTorch versions, which is
what a CPU tensor runs) against the JAX package's Pallas kernels in
interpret mode, at every even d from 2 to 16 with n = 37: ragged against
every packing of the port's warp kernel (⌊32/d⌋ matrices a warp) and
against the Pallas kernels' 1024-matrix tiles, which they pad with the
identity.

Interpret mode runs the unrolled Pallas kernels (``jacobi_project_lanes``,
``jacobi_eigh_lanes``) only at small d: their jaxpr grows as d³ times the
sweeps, and XLA:CPU takes ~35 s at d = 8 with one sweep. So:

* K4 takes the unrolled Pallas kernel at d ≤ 6 and, from d = 8, the
  looped one (``jacobi_project_lanes_looped``), whose rotation arithmetic
  and epilogue are the unrolled kernel's, op for op, with 2 sweeps;
* K6 takes the unrolled Pallas kernel at d ≤ 8 (2 sweeps, one at d = 8)
  and, from d = 10, the JAX package's plain reference of the same
  schedule, ``tomography.bases.batched_jacobi_eigh_small``, with 2 sweeps.

Tolerances: 1e-5 absolute on eigenvalues and eigenvectors, 2e-5 on
projections (the JAX package's own bound between its two projection
kernels): the TPU kernels rotate pair by pair, the port applies a round's
commuting rotations column phase first, so the two differ in rounding only.
Against ``batched_jacobi_eigh_small``, which applies GᵀAG as two matrix
products, 2e-5 on eigenvalues and 2e-4 on eigenvectors, as
``test_torch_jacobi.py`` holds it (measured here: ≤ 1e-5 and ≤ 2e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qinfer_tpu.ops import jacobi as jax_jacobi
from qinfer_tpu.tomography import bases as jax_bases

from qinfer_tpu_torch.ops import jacobi

N = 37
EVEN_D = range(2, 17, 2)


def _random_symmetric(seed, n, d):
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(n, d, d)).astype(np.float32)
    return (b + b.transpose(0, 2, 1)) / 2


@pytest.mark.parametrize("d", EVEN_D)
def test_projection_plain_matches_pallas_at_every_even_d(d):
    a = _random_symmetric(100 + d, N, d)
    pallas = (jax_jacobi.jacobi_project_lanes if d <= 6
              else jax_jacobi.jacobi_project_lanes_looped)
    want = np.asarray(pallas(jnp.asarray(a), sweeps=2, interpret=True))
    got = jacobi.jacobi_project_lanes(torch.from_numpy(a), sweeps=2).numpy()
    assert got.shape == (N, d, d)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.array_equal(got, got.transpose(0, 2, 1))


@pytest.mark.parametrize("d", EVEN_D)
def test_eigh_plain_matches_jax_at_every_even_d(d):
    a = _random_symmetric(200 + d, N, d)
    if d <= 8:
        sweeps, ev_tol, v_tol = (1 if d == 8 else 2), 1e-5, 1e-5
        ev_j, V_j = jax_jacobi.jacobi_eigh_lanes(jnp.asarray(a),
                                                 sweeps=sweeps, interpret=True)
    else:
        sweeps, ev_tol, v_tol = 2, 2e-5, 2e-4
        ev_j, V_j = jax_bases.batched_jacobi_eigh_small(jnp.asarray(a),
                                                        sweeps=sweeps)
    ev, V = jacobi.jacobi_eigh_lanes(torch.from_numpy(a), sweeps=sweeps)
    assert ev.shape == (N, d) and V.shape == (N, d, d)
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), atol=ev_tol,
                               rtol=0)
    np.testing.assert_allclose(V.numpy(), np.asarray(V_j), atol=v_tol,
                               rtol=0)
