"""Parity of the port's resample fill K3 (its plain PyTorch version, which
is what a CPU tensor runs) against the JAX package's
``streaming_resample_locations`` in interpret mode, on the same NumPy
``(m, starts, x)``. The result must be BIT-exact: both compare equal as
int32 views, and equal to ``np.repeat``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qinfer_tpu.ops.streaming_resample import (
    streaming_resample_locations as jax_fill)

from qinfer_tpu_torch.ops.streaming_resample import (
    streaming_resample_locations)

# small tiles keep interpret mode fast; they change tiling, not results
_BLK = dict(block=64, flush=4)


def _counts(w, u):
    """Systematic-resampling copy counts and their exclusive offsets, in
    float64 NumPy."""
    n = w.shape[0]
    cdf = np.cumsum(w.astype(np.float64))
    upper = np.ceil(n * cdf / cdf[-1] - u)
    m = np.diff(np.concatenate([[0.0], upper])).astype(np.int32)
    starts = (np.cumsum(m) - m).astype(np.int32)
    assert m.sum() == n
    return m, starts


def _check(m, starts, x):
    want = np.asarray(jax_fill(jnp.asarray(m), jnp.asarray(starts),
                               jnp.asarray(x), **_BLK))
    got = streaming_resample_locations(
        torch.from_numpy(m), torch.from_numpy(starts), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.repeat(x, m, axis=0).view(np.int32))


@pytest.mark.parametrize("d", [1, 3, 5, 9])
def test_k3_plain_matches_jax_random_weights(d):
    rng = np.random.default_rng(d)
    n = 1024
    w = rng.pareto(0.5, n) + 1e-12
    _check(*_counts(w, 0.37), rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("p", [0, 777, 1023])
def test_k3_plain_matches_jax_point_mass(p):
    n = 1024
    w = np.full(n, 1e-15)
    w[p] = 1.0
    m, starts = _counts(w, 0.5)
    assert m[p] == n
    x = np.random.default_rng(p).normal(size=(n, 2)).astype(np.float32)
    _check(m, starts, x)


def test_k3_plain_matches_jax_two_survivors():
    n = 1024
    w = np.full(n, 1e-15)
    w[3], w[n - 2] = 0.6, 0.4
    m, starts = _counts(w, 0.42)
    assert (m > 0).sum() == 2
    x = np.random.default_rng(1).normal(size=(n, 2)).astype(np.float32)
    _check(m, starts, x)


@pytest.mark.parametrize("n", [300, 1000, 1025])
def test_k3_plain_matches_jax_nonconforming_n(n):
    rng = np.random.default_rng(n)
    w = rng.pareto(0.5, n) + 1e-12
    _check(*_counts(w, 0.31), rng.normal(size=(n, 3)).astype(np.float32))


def test_k3_plain_matches_jax_every_bit_pattern():
    """Subnormals, ±0, NaN payloads and the full exponent range come out
    bit for bit."""
    rng = np.random.default_rng(11)
    n, d = 4096, 2
    w = rng.pareto(0.7, n) + 1e-12
    mant = rng.integers(0, 1 << 23, size=(n, d), dtype=np.int64)
    expo = rng.integers(0, 256, size=(n, d), dtype=np.int64)
    sign = rng.integers(0, 2, size=(n, d), dtype=np.int64) << 31
    x = (sign | (expo << 23) | mant).astype(np.uint32).view(np.float32)
    assert np.isnan(x).any() and (np.abs(x) < np.finfo(np.float32).tiny).any()
    _check(*_counts(w, 0.37), x)
