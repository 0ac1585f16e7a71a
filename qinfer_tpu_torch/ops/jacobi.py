"""Batched small-symmetric eigensolver and PSD-cone projection, kernels
K4-K6 (counterpart of :mod:`qinfer_tpu.ops.jacobi`).

All three run the same parallel-ordered cyclic Jacobi: ``sweeps`` sweeps of
``d − 1`` round-robin rounds (:func:`round_robin_rounds`), each round
rotating the ``d/2`` disjoint pivots (p, q) with the angle that zeroes
``a_pq`` (skipped when ``|a_pq| ≤ 1e-30``). :func:`jacobi_eigh_lanes` (K6)
returns the unsorted eigenvalues and the eigenvectors;
:func:`jacobi_project_lanes` (K4, even d ≤ 16 on the tomography path) and
:func:`jacobi_project_lanes_looped` (K5, 16 < d ≤ 32) clip the eigenvalues
at 0, rescale them to sum to ``trace`` and rebuild ``V diag(ev) Vᵀ``, with
each upper-triangle entry stored to both (i, j) and (j, i), so the output
is exactly symmetric.

Two hand-written CUDA kernels serve them (``csrc/jacobi.cu``): K4 and K6
run the block kernel, one matrix per d/2 threads in shared memory; K5
runs the warp kernel, one matrix per warp in registers, lane r holding
row r (its mate in each round from :func:`round_robin_mate`). The two
round every step alike. The plain PyTorch versions run
the same schedule one batched round at a time with index gathers, each
elementwise step the same rounded operation as the kernel's. A wrapper
uses the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises, and counts launches in its ``launches``
attribute. The kernel takes even d from 2 to 32; callers pad odd d.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels as _k
from ..config import EPS

__all__ = ["round_robin_rounds", "round_robin_mate", "jacobi_eigh_lanes",
           "jacobi_eigh_lanes_plain",
           "jacobi_project_lanes", "jacobi_project_lanes_plain",
           "jacobi_project_lanes_looped", "jacobi_project_lanes_looped_plain"]

#: largest d the kernel takes (its shared-memory layout)
MAX_D = 32
#: pivots at or below this magnitude are skipped
PIVOT_GUARD = 1e-30


def round_robin_rounds(d):
    """Circle-method schedule: ``d − 1`` rounds of ``d/2`` disjoint pairs
    ``(p, q)``, p < q, covering every pair once. Slot 0 of the ring stays
    0 and the others rotate right by one each round, so slot i of round r
    holds ``1 + (i − 1 − r) mod (d − 1)``: the closed form the kernel
    evaluates (``csrc/jacobi.cu::ring_at``)."""

    def ring(i, r):
        return 0 if i == 0 else 1 + (i - 1 - r) % (d - 1)

    return [[(min(ring(i, r), ring(d - 1 - i, r)),
              max(ring(i, r), ring(d - 1 - i, r))) for i in range(d // 2)]
            for r in range(d - 1)]


def round_robin_mate(row, r, d):
    """The row paired with ``row`` in round ``r`` of
    :func:`round_robin_rounds`: the closed form each lane of K5's warp
    kernel evaluates for its own row (``csrc/jacobi.cu``). Row 0 sits in
    slot 0; row i > 0 in slot ``1 + (i − 1 + r) mod (d − 1)``; the mate is
    the row in the opposite slot ``d − 1 − slot``."""
    slot = 0 if row == 0 else 1 + (row - 1 + r) % (d - 1)
    opposite = d - 1 - slot
    return 0 if opposite == 0 else 1 + (opposite - 1 - r + (d - 1)) % (d - 1)


@functools.lru_cache(maxsize=None)
def _pairs(d, device):
    rounds = torch.tensor(round_robin_rounds(d), dtype=torch.long)
    return rounds[..., 0].to(device), rounds[..., 1].to(device)


def _rotate(xp, xq, c, s):
    return c * xp - s * xq, s * xp + c * xq


def _jacobi_plain(a, sweeps):
    """The rotation rounds on a batch (n, d, d): returns the rotated ``A``
    (eigenvalues on its diagonal) and ``V``."""
    n, d, _ = a.shape
    A = a.clone()
    V = torch.eye(d, dtype=a.dtype, device=a.device).expand(n, d, d).clone()
    P, Q = _pairs(d, a.device)
    for _ in range(int(sweeps)):
        for p, q in zip(P, Q):
            apq, app, aqq = A[:, p, q], A[:, p, p], A[:, q, q]  # (n, d/2)
            small = torch.abs(apq) <= PIVOT_GUARD
            theta = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
            sgn = torch.where(theta >= 0, 1.0, -1.0)
            # theta² overflows to inf for a tiny pivot: t = 0, never NaN
            t = sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            cc = 1.0 / torch.sqrt(t * t + 1.0)
            c = torch.where(small, 1.0, cc)
            s = torch.where(small, 0.0, t * cc)
            # columns of A and V, then rows of A (the kernel's order)
            cr, sr = c[:, None, :], s[:, None, :]
            A[:, :, p], A[:, :, q] = _rotate(A[:, :, p], A[:, :, q], cr, sr)
            V[:, :, p], V[:, :, q] = _rotate(V[:, :, p], V[:, :, q], cr, sr)
            cr, sr = c[:, :, None], s[:, :, None]
            A[:, p, :], A[:, q, :] = _rotate(A[:, p, :], A[:, q, :], cr, sr)
    return A, V


def _check_plain(name, a):
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"{name} takes (n, d, d) matrices, got "
                         f"{tuple(a.shape)}")
    if a.shape[-1] % 2:
        raise ValueError(f"{name} requires even d (pad first)")


def jacobi_eigh_lanes_plain(a, sweeps=6):
    """Plain PyTorch version of :func:`jacobi_eigh_lanes`."""
    _check_plain("jacobi_eigh_lanes", a)
    A, V = _jacobi_plain(a, sweeps)
    return torch.diagonal(A, dim1=-2, dim2=-1).clone(), V


def jacobi_project_lanes_plain(a, sweeps=6, trace=2.0, eps=EPS):
    """Plain PyTorch version of :func:`jacobi_project_lanes` and
    :func:`jacobi_project_lanes_looped`: the kernel's epilogue order (the
    clipped trace summed in index order, each entry a sum over b in
    order, the upper triangle mirrored)."""
    _check_plain("jacobi_project_lanes", a)
    A, V = _jacobi_plain(a, sweeps)
    d = a.shape[-1]
    ev = torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1), 0.0)
    tr = ev[:, 0]
    for i in range(1, d):
        tr = tr + ev[:, i]
    evs = ev * (trace / torch.clamp_min(tr, eps))[:, None]
    W = V * evs[:, None, :]
    acc = W[:, :, 0, None] * V[:, None, :, 0]
    for b in range(1, d):
        acc = acc + W[:, :, b, None] * V[:, None, :, b]
    upper = torch.ones((d, d), dtype=torch.bool, device=a.device).triu()
    return torch.where(upper, acc, acc.transpose(-1, -2))


jacobi_project_lanes_looped_plain = jacobi_project_lanes_plain


def _check_cuda(name, a):
    _k.require_cuda(name, a, torch.float32, 3)
    n, d, d2 = a.shape
    if d != d2 or d % 2 or not 2 <= d <= MAX_D or n == 0:
        raise ValueError(
            f"{name} takes a nonempty (n, d, d) batch with even "
            f"2 <= d <= {MAX_D}, got {tuple(a.shape)}")


def _project(name, entry, a, sweeps, trace, eps):
    _check_cuda(name, a)
    n, d, _ = a.shape
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        status = getattr(_k.library(), entry)(
            _k.ptr(a), _k.ptr(out), n, d, int(sweeps), ctypes.c_float(trace),
            ctypes.c_float(eps), _k.stream_of(a.device))
    _k.check(status, name)
    return out


def jacobi_eigh_lanes(a, sweeps=6):
    """Eigendecomposition of a batch of small symmetric matrices
    ``(n, d, d)``, d even.

    :return: ``(ev, V)`` with ``a ≈ V diag(ev) Vᵀ``; eigenvalues unsorted,
        ``V`` orthogonal (a product of rotations).
    """
    if not a.is_cuda:
        return jacobi_eigh_lanes_plain(a, sweeps)
    _check_cuda("jacobi_eigh_lanes", a)
    n, d, _ = a.shape
    ev = torch.empty((n, d), dtype=a.dtype, device=a.device)
    V = torch.empty_like(a)
    with torch.cuda.device(a.device):
        status = _k.library().qk_jacobi_eigh(
            _k.ptr(a), _k.ptr(ev), _k.ptr(V), n, d, int(sweeps),
            _k.stream_of(a.device))
    _k.check(status, "jacobi_eigh_lanes")
    jacobi_eigh_lanes.launches += 1
    return ev, V


def jacobi_project_lanes(a, sweeps=6, trace=2.0, eps=EPS):
    """PSD-cone projection of a batch of small symmetric matrices
    ``(n, d, d)``, d even: eigendecompose, clip the eigenvalues at 0,
    rescale them to sum to ``trace`` (``eps`` floors the clipped sum) and
    rebuild. The tomography path's projection for embedded d ≤ 16."""
    if not a.is_cuda:
        return jacobi_project_lanes_plain(a, sweeps, trace, eps)
    out = _project("jacobi_project_lanes", "qk_jacobi_project", a, sweeps,
                   trace, eps)
    jacobi_project_lanes.launches += 1
    return out


def jacobi_project_lanes_looped(a, sweeps=6, trace=2.0, eps=EPS):
    """:func:`jacobi_project_lanes`'s contract, the tomography path's
    projection for embedded 16 < d ≤ 32 (two-qubit channels' Choi
    states), by the warp kernel (any even d ≤ 32). Counted apart from
    it."""
    if not a.is_cuda:
        return jacobi_project_lanes_looped_plain(a, sweeps, trace, eps)
    out = _project("jacobi_project_lanes_looped", "qk_jacobi_project_warp",
                   a, sweeps, trace, eps)
    jacobi_project_lanes_looped.launches += 1
    return out


jacobi_eigh_lanes.launches = 0
jacobi_project_lanes.launches = 0
jacobi_project_lanes_looped.launches = 0
