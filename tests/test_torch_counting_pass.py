"""The counting pass's order of summation, modelled in NumPy float32: the
card's chain (``qinfer_tpu_torch/csrc/counting_pass.cu``) nests a
thread's 16 weights, a warp's 32 threads, a block's 8 warps and the
tiles of 4096, each part's base the previous base plus the previous
part's total; the carry between tiles is float64. The model shows on
adversarial weights that the ceilings never decrease with no ``cummax``
and that the pass's invariants hold; on the CPU the port takes the plain
version. ``tests/test_torch_cuda.py`` holds the card's chain to this
model bit for bit. The module imports no JAX."""

import numpy as np
import pytest
import torch

from qinfer_tpu_torch.config import EPS
from qinfer_tpu_torch.ops import counting_pass as cp
from qinfer_tpu_torch.resamplers import counting_multiplicities_from_u

TILE, WARPS, LANES, PER = 4096, 8, 32, 16
BELOW_ONE = np.float32(1.0 - 2.0 ** -24)


def chain_prefixes(w):
    """The chain's float32 prefix sums of one row, in its order."""
    n = w.shape[0]
    tiles = -(-n // TILE)
    x = np.zeros(tiles * TILE, np.float32)
    x[:n] = w
    x = x.reshape(tiles, WARPS, LANES, PER)
    f32 = np.float32
    loc = np.add.accumulate(x, axis=-1, dtype=f32)
    lanes = np.add.accumulate(loc[..., -1], axis=-1, dtype=f32)
    lane_base = np.concatenate([np.zeros_like(lanes[..., :1]),
                                lanes[..., :-1]], axis=-1)
    warps = np.add.accumulate(lanes[..., -1], axis=-1, dtype=f32)
    warp_base = np.concatenate([np.zeros_like(warps[:, :1]), warps[:, :-1]],
                               axis=-1)
    s = (warp_base[:, :, None, None]
         + (lane_base[..., None] + loc).astype(f32)).astype(f32)
    carry = np.add.accumulate(warps[:, -1].astype(np.float64))
    carry = np.concatenate([[0.0], carry[:-1]])
    v = (carry[:, None, None, None] + s.astype(np.float64)).astype(f32)
    return v.reshape(-1)[:n]


def chain_ceilings(w, u, n_out):
    """The chain's ceilings ``ceil(n_out·c − u)`` of one row (int64), with
    the clamp and the ``reached`` rule of the plain version, no cummax."""
    v = chain_prefixes(np.asarray(w, np.float32))
    denom = np.maximum(v[-1], np.float32(EPS))
    c = np.minimum(v / denom, np.float32(1.0))
    upper = np.ceil(np.float32(n_out) * c - np.float32(u))
    reached = c >= 1.0
    reached[-1] = True
    return np.where(reached, n_out, upper).astype(np.int64)


def chain_counts(w, u, n_out):
    """``(m, offsets)`` of one row or a batch (rows, n) as the chain
    writes them (int32)."""
    w = np.asarray(w, np.float32)
    if w.ndim == 2:
        us = np.broadcast_to(np.asarray(u, np.float32), (w.shape[0],))
        pairs = [chain_counts(row, ur, n_out) for row, ur in zip(w, us)]
        return tuple(np.stack(p) for p in zip(*pairs))
    upper = chain_ceilings(w, u, n_out)
    lower = np.concatenate([[0], upper[:-1]])
    return ((upper - lower).astype(np.int32),
            np.maximum(lower, 0).astype(np.int32))


def float64_ceilings(w, u, n_out):
    """``ceil(n_out·F − u)`` of the float64 CDF, the last one n_out."""
    cdf = np.cumsum(np.asarray(w, np.float64))
    upper = np.ceil(n_out * (cdf / cdf[-1]) - np.float64(np.float32(u)))
    upper[-1] = n_out
    return upper.astype(np.int64)


def _weights(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        w = rng.random(n, dtype=np.float32)
    elif kind == "steep":
        w = rng.random(n, dtype=np.float32) ** 8 + np.float32(1e-12)
    elif kind == "zeros":
        w = rng.random(n, dtype=np.float32)
        w[rng.random(n) < 0.7] = 0.0
        w[:TILE // 2] = 0.0
        w[-(TILE + 37):] = 0.0
    elif kind == "tail_1e-30":
        w = np.full(n, 1e-30, np.float32)
        w[: n // 3] = rng.random(n // 3, dtype=np.float32)
    elif kind == "dominant":
        w = np.full(n, 1e-30, np.float32)
        w[rng.integers(n)] = 1.0
    else:  # "two_dominant": one on each side of a tile boundary
        w = np.zeros(n, np.float32)
        w[[TILE - 1, TILE]] = 1.0
    return (w / np.float32(w.sum(dtype=np.float64))).astype(np.float32)


def _hold_invariants(w, u, n_out, upper):
    m = np.diff(np.concatenate([[0], upper]))
    assert (m >= 0).all(), "a ceiling decreased"
    assert upper[-1] == n_out and m.sum() == n_out
    offsets = np.concatenate([[0], upper[:-1]])
    np.testing.assert_array_equal(offsets, np.cumsum(m) - m)
    if w.astype(np.float64).sum() >= EPS:
        assert m[w == 0].sum() == 0, "a zero weight got a slot"


KINDS = ("random", "steep", "zeros", "tail_1e-30", "dominant",
         "two_dominant")


@pytest.mark.parametrize("kind, n", [("random", 2 ** 22), ("zeros", 2 ** 22)]
                         + [(k, n) for n in (3 * TILE + 1001, 50_000)
                            for k in KINDS])
def test_chain_ceilings_never_decrease_without_cummax(kind, n):
    """The model's ceilings, with no cummax, never decrease; Σ m = n, the
    offsets are the exclusive sums of m and no zero weight gets a slot,
    at 2²² (1024 tiles), at a length that is no multiple of the tile and
    at 50 000; each ceiling within one slot of the float64 count."""
    w = _weights(kind, n, seed=n % 1000 + len(kind))
    for u in (0.0, 0.37, float(BELOW_ONE)):
        upper = chain_ceilings(w, u, n)
        _hold_invariants(w, u, n, upper)
        assert np.abs(upper - float64_ceilings(w, u, n)).max() <= 1


def test_chain_prefixes_never_decrease_across_every_boundary():
    """The prefixes themselves: across a thread's, a warp's and a tile's
    boundary, on weights spread over twelve decades."""
    rng = np.random.default_rng(3)
    n = 5 * TILE + 123
    w = (10.0 ** rng.uniform(-12, 0, n)).astype(np.float32)
    v = chain_prefixes(w)
    assert (np.diff(v) >= 0).all()
    total = w.astype(np.float64).sum()
    assert abs(float(v[-1]) - total) <= 1e-6 * total


@pytest.mark.parametrize("n", [2 ** 22, 131_072])
def test_chain_keeps_the_last_slot_for_offsets_near_one(n):
    """u = 1 − 2⁻²⁴, where float32 rounds n − u down: the last slot goes to
    the last particle of positive weight, zeros after it get none."""
    w = np.full(n, 1.0, np.float32)
    w[-100:] = 0.0
    w[n // 2] = 0.0
    w /= w.sum()
    upper = chain_ceilings(w, BELOW_ONE, n)
    _hold_invariants(w, BELOW_ONE, n, upper)
    m = np.diff(np.concatenate([[0], upper]))
    assert m[n - 101] >= 1 and m[n - 100:].sum() == 0


def test_chain_gives_every_slot_to_the_last_particle_below_eps():
    """A total below EPS: every prefix stays short of 1, and the forced
    last ceiling takes all n slots, as in the plain version."""
    w = np.zeros(TILE + 5, np.float32)
    m, offsets = chain_counts(w, 0.5, w.shape[0])
    pm, po = cp.counting_multiplicities_from_u_plain(
        0.5, torch.from_numpy(w), w.shape[0])
    assert m[-1] == w.shape[0] and m[:-1].sum() == 0
    np.testing.assert_array_equal(m, pm.numpy())
    np.testing.assert_array_equal(offsets, po.numpy())


@pytest.mark.parametrize("shape", [(1,), (1000,), (3 * TILE + 1001,),
                                   (3, 2 * TILE + 5)])
def test_chain_equals_plain_on_dyadic_weights(shape):
    """Small integers sum exactly in any order: the model and the plain
    version (and so the card's chain) give the same counts to the bit."""
    rng = np.random.default_rng(shape[-1])
    w = rng.integers(0, 4, size=shape).astype(np.float32)
    w.reshape(-1, shape[-1])[:, -1] = 1.0
    n = shape[-1]
    u = rng.random(shape[:-1], dtype=np.float32) if len(shape) > 1 else (
        np.float32(0.61))
    m, offsets = chain_counts(w, u, n)
    pm, po = cp.counting_multiplicities_from_u_plain(
        torch.as_tensor(u), torch.from_numpy(w), n)
    np.testing.assert_array_equal(m, pm.numpy())
    np.testing.assert_array_equal(offsets, po.numpy())


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is the plain version, to the bit, and counts
    no launch (one row and a batch)."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.random((4, 5000), dtype=np.float32))
    u = torch.from_numpy(rng.random(4, dtype=np.float32))
    before = counting_multiplicities_from_u.launches
    for args in ((u, w, 5000), (u[1], w[1], 5000), (0.3, w[2], 2500)):
        got = counting_multiplicities_from_u(*args)
        want = cp.counting_multiplicities_from_u_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counting_multiplicities_from_u.launches == before
