"""The yardstick's arithmetic: the card's peaks and each kernel's least
time, frozen here so that edits to the program's own copies cannot move
it.

Frozen copies, with their origin:

* :data:`HBM_BYTES_PER_S`, :data:`F32_OPS_PER_S`, :func:`bound` and
  :func:`jacobi_ops` (the operation count of ``jacobi_bound``) from
  ``chip_smoke.py`` at the root of the repository;
* :func:`k3_fixed_bytes` from ``chip_smoke.k3_bytes``, keeping only the
  bytes that do not depend on the call's copy counts: the starts read and
  the output written. The rows the counts make the kernel read are not
  seen from outside the program, so they are not counted: the share is a
  lower bound of the true one;
* :func:`k1_bytes`, the K1 bound of ``chip_smoke.hold_k1``: 12 bytes a
  particle (ω and w read, h written).
"""

from __future__ import annotations

#: H100 SXM data sheet: device-memory bytes a second
HBM_BYTES_PER_S = 3.35e12
#: float32 operations a second outside the tensor cores, each rounded on
#: its own (the sheet's 67 TFLOP/s count an FMA as 2)
F32_OPS_PER_S = 33.5e12


def bound(nbytes, ops):
    """``(bound_s, bound_by)``: the least time of work that moves
    ``nbytes`` of device memory and does ``ops`` float32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def k1_bytes(n):
    return 12 * n


def k3_fixed_bytes(rows, d):
    """Starts read (4 B a row) and the output written (4·d B a row)."""
    return 4 * rows + 4 * d * rows


def jacobi_ops(n, d, sweeps, project):
    """Operations of a Jacobi call on ``n`` (d, d) matrices: per rotation
    15 for the angle and 18·d for the columns of A and V and the rows of
    A; the projection's epilogue 4·d for the clipped trace and 3·d − 1 per
    upper-triangle entry."""
    ops = sweeps * (d - 1) * (d // 2) * (18 * d + 15)
    if project:
        ops += 4 * d + d * (d + 1) // 2 * (3 * d - 1)
    return n * ops


def jacobi_bytes(n, d, project):
    """The batch read once and written once (and d eigenvalues for the
    eigensolver)."""
    return n * (8 * d * d + (0 if project else 4 * d))
