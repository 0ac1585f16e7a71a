"""Systematic-resample fill, kernel K3 (counterpart of
:mod:`qinfer_tpu.ops.streaming_resample`).

Particle ``i`` owns the contiguous output span ``[starts_i, starts_i +
m_i)``; the fill writes ``m_i`` copies of its coordinates there, which is
``np.repeat(x, m, axis=0)``. The hand-written CUDA kernel
(``csrc/streaming_resample.cu``) finds each output slot's owner by a binary
search over ``starts`` and copies raw 32-bit words, so the result is
bit-exact for every float32 pattern. The plain PyTorch version repeats the
int32 view of the rows, which is bit-exact too. The wrapper uses the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises, and counts launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from .. import kernels as _k

__all__ = ["streaming_resample_locations",
           "streaming_resample_locations_plain"]


def streaming_resample_locations_plain(m, starts, locations):
    """Plain PyTorch version of :func:`streaming_resample_locations` (uses
    ``m``; ``starts`` is implied by it)."""
    n = locations.shape[0]
    return (locations.view(torch.int32)
            .repeat_interleave(m, dim=0, output_size=n)
            .view(torch.float32))


def streaming_resample_locations(m, starts, locations):
    """Expand each particle's coordinates into its output span.

    :param m: (n,) int32 copy counts with ``Σ m = n``, from
        :func:`qinfer_tpu_torch.resamplers.counting_multiplicities_from_u`.
    :param starts: (n,) int32 first output slot of each particle (the
        exclusive cumsum of ``m``).
    :param locations: (n, d) float32 particle coordinates.
    :return: (n, d) resampled locations, bit-identical to
        ``np.repeat(locations, m, axis=0)``.
    """
    if not locations.is_cuda:
        return streaming_resample_locations_plain(m, starts, locations)
    _k.require_cuda("m", m, torch.int32, 1)
    _k.require_cuda("starts", starts, torch.int32, 1)
    _k.require_cuda("locations", locations, torch.float32, 2)
    n, d = locations.shape
    if m.shape[0] != n or starts.shape[0] != n or n == 0 or d == 0:
        raise ValueError(
            f"m {tuple(m.shape)}, starts {tuple(starts.shape)} and locations "
            f"{tuple(locations.shape)} must agree on a nonzero n (and d > 0)")
    if not (m.device == starts.device == locations.device):
        raise ValueError("m, starts and locations must be on one device")
    dev = locations.device
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = _k.library().qk_streaming_resample_locations(
            _k.ptr(starts), _k.ptr(locations), _k.ptr(out), n, d,
            _k.stream_of(dev))
    _k.check(status, "streaming_resample_locations")
    streaming_resample_locations.launches += 1
    return out


streaming_resample_locations.launches = 0
