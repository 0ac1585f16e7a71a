"""The counting pass of systematic resampling: each particle's copy count
and first output slot, from the weights and a uniform offset.

On the card the pass is a hand-written CUDA chain
(``csrc/counting_pass.cu``): a multi-block scan in a fixed order whose
prefix sums never decrease, so the ceilings need no ``cummax``, and the
same input gives the same bits. The plain PyTorch version (one
``utils.cumsum_last``, the ceilings and a ``cummax``) is the route for
tensors on the CPU; for a CUDA tensor the wrapper launches the chain or
raises, and counts chains in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels as _k
from ..config import EPS
from ..utils import cumsum_last

__all__ = ["counting_multiplicities_from_u",
           "counting_multiplicities_from_u_plain"]

#: the most slots a float32 ceiling counts exactly
_MAX_SLOTS = 2 ** 24


def counting_multiplicities_from_u_plain(u, weights, n_out):
    """Plain PyTorch version of :func:`counting_multiplicities_from_u`."""
    if torch.is_tensor(u) and u.ndim == 1:
        u = u[:, None]
    cdf = cumsum_last(weights)
    # a parallel cumsum (the GPU's) may leave a prefix an ulp above the
    # total; the clamp keeps every ceiling at or below n_out so Σ m = n_out
    cdf = torch.clamp_max(
        cdf / torch.clamp_min(cdf[..., -1:], EPS), 1.0)
    # a prefix that has reached the total has ceiling ceil(n_out − u) =
    # n_out for every u in [0, 1), but float32 rounds n_out − u down to
    # n_out − 1 when u lies within half an ulp of n_out below 1 (u > 0.996
    # at n = 2¹⁷, > 0.875 at 2²²), which would hand the last slot to the
    # last particle whatever its weight; every such ceiling is set
    # exactly, so the slot goes to the first particle whose prefix reaches
    # the total (the last one of positive weight). The last prefix counts
    # as reached even when a total below EPS leaves it short of 1.
    reached = cdf >= 1.0
    reached[..., -1] = True
    upper = torch.where(reached, float(n_out), torch.ceil(n_out * cdf - u))
    # the prefix sums can also dip by an ulp; cummax restores monotonicity
    # so no m is negative and no spans overlap
    upper = torch.cummax(upper, dim=-1).values
    lower = torch.cat([torch.zeros_like(upper[..., :1]), upper[..., :-1]],
                      dim=-1)
    m = (upper - lower).to(torch.int32)
    offsets = torch.clamp_min(lower, 0.0).to(torch.int32)
    return m, offsets


@functools.lru_cache(maxsize=None)
def _tile():
    """Weights a block of the chain scans (the library's constant)."""
    return _k.library().qk_counting_pass_tile()


def _offsets_on(u, rows, device):
    """``(tensor or None, value, stride)``: the offsets as the chain reads
    them, a float32 tensor on ``device`` with one entry a row (stride 1)
    or one for all rows (stride 0), or a Python number by value."""
    if not torch.is_tensor(u):
        return None, float(u), 0
    u = u.reshape(-1)
    if u.numel() not in (1, rows):
        raise ValueError(f"{u.numel()} offsets for {rows} rows of weights")
    u = u.to(device=device, dtype=torch.float32).contiguous()
    return u, 0.0, int(u.numel() > 1)


def counting_multiplicities_from_u(u, weights, n_out):
    """Per-particle copy counts and output offsets of systematic resampling
    with uniform offset ``u``, from one scan and elementwise math.

    ``m_i = ceil(n·F_i − u) − ceil(n·F_{i−1} − u)`` counts the stratified
    positions ``(j + u)/n`` that land in ``(F_{i−1}, F_i]``; the exclusive
    cumsum of ``m`` is ``ceil(n·F_{i−1} − u)`` itself. ``n·F`` amplifies
    float32 CDF rounding, so a boundary assignment can shift by one slot
    relative to another summation order (the card's chain and the plain
    version sum in different orders); ``Σ m = n`` holds exactly and no
    slot goes to a particle of zero weight (the JAX package's loses the
    last slot when float32 rounds ``n − u`` down: see the plain version).

    Batched: ``weights`` (T, n) with ``u`` (T,) counts each row along the
    last axis with its own offset, so every row keeps ``Σ m = n``; on the
    card a row of a batch gives the bits it gives alone.

    :param u: uniform offset in [0, 1) (number or 0-d tensor; (T,) for
        batched weights).
    :return: ``(m, offsets)``, both int32 of the weights' shape.
    """
    if not weights.is_cuda:
        return counting_multiplicities_from_u_plain(u, weights, n_out)
    if weights.ndim not in (1, 2) or weights.numel() == 0:
        raise ValueError(f"weights must be (n,) or (T, n) and nonempty, got "
                         f"{tuple(weights.shape)}")
    _k.require_cuda("weights", weights, torch.float32, weights.ndim)
    n_out = int(n_out)
    if not 0 <= n_out <= _MAX_SLOTS:
        raise ValueError(f"n_out = {n_out} slots: float32 ceilings count "
                         f"0 to {_MAX_SLOTS} exactly")
    n = weights.shape[-1]
    rows = weights.numel() // n
    dev = weights.device
    u_dev, u_val, u_stride = _offsets_on(u, rows, dev)
    tiles = -(-n // _tile())
    sums = torch.empty((rows * (tiles + 1),), dtype=torch.float64,
                       device=dev)
    m = torch.empty(weights.shape, dtype=torch.int32, device=dev)
    offsets = torch.empty(weights.shape, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = _k.library().qk_counting_pass(
            _k.ptr(weights), rows, n,
            None if u_dev is None else _k.ptr(u_dev), u_stride,
            ctypes.c_float(u_val), n_out, ctypes.c_float(EPS), _k.ptr(sums),
            _k.ptr(m), _k.ptr(offsets), _k.stream_of(dev))
    _k.check(status, "counting_multiplicities_from_u")
    counting_multiplicities_from_u.launches += 1
    return m, offsets


counting_multiplicities_from_u.launches = 0
