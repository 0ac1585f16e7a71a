"""Precession-model kernels K1 and K2 (counterpart of
:mod:`qinfer_tpu.ops.precession`).

K1 :func:`fused_precession_update` fuses the whole per-step weight update
of the precession model into one pass over the particles::

    pr0_i = cos²(ω_i · (t · 0.5))
    ℓ_i   = pr0_i if outcome == 0 else 1 − pr0_i
    h_i   = w_i · ℓ_i
    plus the step's reductions Σh, Σh², Σhω

K2 :func:`precession_pr0` computes the cos² table for a batch of
experiment times.

Each kernel is hand-written CUDA (``csrc/precession.cu``) beside a plain
PyTorch version of the same function. A wrapper uses the plain version
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. Each wrapper counts its launches in its ``launches`` attribute.

K1 is one launch: it also computes the epilogue (norm, ESS, mean), and it
reads ``t`` and the outcome where the engine keeps them (float32 and int32
or int64 on the card; a Python number or a CPU tensor goes by value), so a
``normalize=False`` call runs no other device work.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as _k

__all__ = ["fused_precession_update", "fused_precession_update_plain",
           "precession_pr0", "precession_pr0_plain"]

_SAFE = 1e-35


def _scalar_on(x, device, dtype):
    """A scalar (Python number or tensor) as a 1-element tensor on
    ``device``; a tensor already there is not copied."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)[:1].to(device=device, dtype=dtype)
    return torch.full((1,), x, dtype=dtype, device=device)


def _finish(h, sums, normalize):
    """The plain version's epilogue (the kernel computes it in its last
    block): ``(h/Σh or h, norm=Σh, ess=(Σh)²/Σh², mean=Σhω/Σh)``."""
    norm, sum_h2, sum_hw = sums[0], sums[1], sums[2]
    safe = torch.clamp_min(norm, _SAFE)
    out_w = h / safe if normalize else h
    ess = safe * safe / torch.clamp_min(sum_h2, _SAFE)
    mean = sum_hw / safe
    return out_w, norm, ess, mean


_K1_SCRATCH = {}


def _k1_scratch(device, stream):
    """K1's scratch (block partials and the last-block ticket), one zeroed
    buffer per stream, kept across calls: each call leaves it ready for the
    next, so a call fills nothing."""
    key = (device, stream)
    if key not in _K1_SCRATCH:
        _K1_SCRATCH[key] = torch.zeros(
            (_k.library().qk_fused_precession_scratch_words(),),
            dtype=torch.int32, device=device)
    return _K1_SCRATCH[key]


def _device_scalar(x, device, dtypes, cast):
    """``(tensor or None, value)``: a one-element tensor already on
    ``device`` in one of ``dtypes`` is read by the kernel where it is; a
    Python number or a CPU tensor is passed by value; a tensor on the card
    in another dtype is cast (one small kernel)."""
    if not isinstance(x, torch.Tensor):
        return None, cast(x)
    x = x.reshape(-1)[:1]
    if x.device != device:
        return None, cast(x.item())
    return (x if x.dtype in dtypes else x.to(dtypes[0])), cast(0)


def fused_precession_update_plain(omega, weights, t, outcome,
                                  normalize=True):
    """Plain PyTorch version of :func:`fused_precession_update`."""
    t = _scalar_on(t, omega.device, torch.float32)
    outcome = _scalar_on(outcome, omega.device, torch.int32)
    c = torch.cos(omega * (t * 0.5))
    pr0 = c * c
    ell = torch.where(outcome == 0, pr0, 1.0 - pr0)
    h = weights * ell
    sums = torch.stack([torch.sum(h), torch.sum(h * h), torch.sum(h * omega)])
    return _finish(h, sums, normalize)


def fused_precession_update(omega, weights, t, outcome, normalize=True):
    """Fused SMC reweighting step for the precession model.

    :param omega: (n,) float32 particle frequencies; may be a strided
        column of the (n, d) location matrix.
    :param weights: (n,) float32 current weights.
    :param t: scalar evolution time (number or tensor).
    :param outcome: scalar observed outcome, 0 or 1 (number or tensor).
    :param normalize: return ``h / Σh`` instead of ``h``.
    :return: ``(new_weights, norm, ess, mean)``: the posterior weights plus
        the step's normalization Σh, effective sample size and posterior
        mean frequency (0-d tensors).
    """
    if not omega.is_cuda:
        return fused_precession_update_plain(omega, weights, t, outcome,
                                             normalize)
    _k.require_cuda("omega", omega, torch.float32, 1, contiguous=False)
    _k.require_cuda("weights", weights, torch.float32, 1)
    n = omega.shape[0]
    if weights.shape[0] != n or n == 0:
        raise ValueError(f"omega {tuple(omega.shape)} and weights "
                         f"{tuple(weights.shape)} must be the same nonzero "
                         "length")
    if weights.device != omega.device:
        raise ValueError("omega and weights must be on the same device")
    dev = omega.device
    t_dev, t_val = _device_scalar(t, dev, (torch.float32,), float)
    o_dev, o_val = _device_scalar(outcome, dev, (torch.int32, torch.int64),
                                  int)
    h = torch.empty((n,), dtype=torch.float32, device=dev)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = _k.stream_of(dev)
        status = _k.library().qk_fused_precession_update(
            _k.ptr(omega), omega.stride(0), _k.ptr(weights),
            None if t_dev is None else _k.ptr(t_dev), ctypes.c_float(t_val),
            None if o_dev is None else _k.ptr(o_dev),
            int(o_dev is not None and o_dev.dtype == torch.int64), o_val,
            _k.ptr(h), _k.ptr(_k1_scratch(dev, stream.value)), _k.ptr(out),
            n, stream)
    _k.check(status, "fused_precession_update")
    fused_precession_update.launches += 1
    # out: norm, ess, mean, max(norm, 1e-35)
    return (h / out[3] if normalize else h), out[0], out[1], out[2]


fused_precession_update.launches = 0


def precession_pr0_plain(omega, ts):
    """Plain PyTorch version of :func:`precession_pr0`."""
    c = torch.cos(omega[:, None] * (ts[None, :] * 0.5))
    return c * c


def precession_pr0(omega, ts):
    """Pr(0 | ω; t) = cos²(ω · (t · 0.5)) over particles × experiments.

    :param omega: (n,) float32 frequencies; may be a strided column.
    :param ts: (n_e,) float32 experiment times on the same device.
    :return: (n, n_e) float32 table.
    """
    if not omega.is_cuda:
        return precession_pr0_plain(omega, ts)
    _k.require_cuda("omega", omega, torch.float32, 1, contiguous=False)
    _k.require_cuda("ts", ts, torch.float32, 1)
    n, n_e = omega.shape[0], ts.shape[0]
    if n == 0 or n_e == 0:
        raise ValueError("precession_pr0 needs n > 0 and n_e > 0")
    if ts.device != omega.device:
        raise ValueError("omega and ts must be on the same device")
    dev = omega.device
    out = torch.empty((n, n_e), dtype=torch.float32, device=dev)
    lib = _k.library()
    with torch.cuda.device(dev):
        status = lib.qk_precession_pr0(
            _k.ptr(omega), omega.stride(0), _k.ptr(ts), _k.ptr(out), n, n_e,
            _k.stream_of(dev))
    _k.check(status, "precession_pr0")
    precession_pr0.launches += 1
    return out


precession_pr0.launches = 0
