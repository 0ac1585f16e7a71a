"""Carry SMC state between the JAX package and the port as NumPy arrays.

:func:`state_from_numpy` takes the arrays of a ``qinfer_tpu.smc.SMCState``
(``{f: np.asarray(getattr(state, f)) for f in state._fields}``; the PRNG
``key`` is ignored, since the port draws from a :class:`torch.Generator`)
and builds the port's :class:`~qinfer_tpu_torch.smc.SMCState` on a device
(the card unless the caller asks for the CPU, as every entry point);
:func:`state_to_numpy` goes back. The tests use them so that both packages
step from the same ensemble. :func:`tomography_basis_from_numpy` builds the
port's tomography basis from the same host arrays as a JAX basis (``data``,
``dims``, ``labels``).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_DEVICE, resolve_device
from .smc import SMCState
from .tomography.bases import TomographyBasis

__all__ = ["state_from_numpy", "state_to_numpy",
           "tomography_basis_from_numpy"]

#: fields that are tensors in the port, with their dtype
_TENSOR_FIELDS = {
    "weights": torch.float32,
    "locations": torch.float32,
    "log_total_likelihood": torch.float32,
    "min_n_ess": torch.float32,
    "resampler_fallback_count": torch.int32,
}
#: fields the port keeps as Python numbers
_HOST_FIELDS = {
    "resample_count": int,
    "just_resampled": bool,
    "zero_weight_count": int,
}


def state_from_numpy(arrays, device=DEFAULT_DEVICE):
    """Build an :class:`SMCState` on ``device`` from a mapping of field name
    to array (extra keys, such as a JAX ``key``, are ignored). Without a
    CUDA device, pass ``device="cpu"``: the default raises there."""
    device = resolve_device(device)
    fields = {name: torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                                 device=device)
              for name, dtype in _TENSOR_FIELDS.items()}
    fields.update({name: cast(np.asarray(arrays[name]).item())
                   for name, cast in _HOST_FIELDS.items()})
    return SMCState(**fields)


def state_to_numpy(state):
    """The fields of an :class:`SMCState` as NumPy arrays (float32 / int32 /
    bool, the dtypes of the JAX package's state)."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in _TENSOR_FIELDS}
    out["resample_count"] = np.int32(state.resample_count)
    out["just_resampled"] = np.bool_(state.just_resampled)
    out["zero_weight_count"] = np.int32(state.zero_weight_count)
    return out


def tomography_basis_from_numpy(data, dims, labels=None):
    """A :class:`~qinfer_tpu_torch.tomography.bases.TomographyBasis` from
    its complex operators ``data`` (n_ops, d, d), subsystem ``dims`` and
    ``labels``: e.g. ``np.asarray(jax_basis.data)``, ``jax_basis.dims``,
    ``jax_basis.labels``."""
    return TomographyBasis(np.asarray(data), dims, labels)
