"""Carry SMC state between the JAX package and the port as NumPy arrays.

:func:`state_from_numpy` takes the arrays of a ``qinfer_tpu.smc.SMCState``
(``{f: np.asarray(getattr(state, f)) for f in state._fields}``; the PRNG
``key`` is ignored, since the port draws from a :class:`torch.Generator`)
and builds the port's :class:`~qinfer_tpu_torch.smc.SMCState` on a device
(the card unless the caller asks for the CPU, as every entry point);
:func:`state_to_numpy` goes back. The tests use them so that both packages
step from the same ensemble. :func:`tomography_basis_from_numpy` builds the
port's tomography basis from the same host arrays as a JAX basis (``data``,
``dims``, ``labels``). :func:`distribution_from_numpy` and
:func:`gaussian_random_walk_from_numpy` build the port's priors and walk
models from a JAX object's parameters as NumPy arrays (an interpolated
distribution's CDF grid, a GADFLI prior's embedded fiducial state, a
walk's step covariance; a learned walk's tail lives in the particles and
comes over with :func:`state_from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import distributions
from .derived_models import GaussianRandomWalkModel
from .parallel.mesh import placement, shard_state
from .smc import SMCState
from .tomography.bases import TomographyBasis
from .tomography.distributions import GADFLIDistribution

__all__ = ["state_from_numpy", "state_to_numpy",
           "tomography_basis_from_numpy", "distribution_from_numpy",
           "gaussian_random_walk_from_numpy"]

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


def state_from_numpy(arrays, device=None, sharding=None):
    """Build an :class:`SMCState` on ``device`` (the card by default) from a
    mapping of field name to array (extra keys, such as a JAX ``key``, are
    ignored). Without a CUDA device, pass ``device="cpu"``: the default
    raises there. With a particle ``sharding`` the state lands on its
    mesh's device, its particles checked to split into equal shards."""
    device = placement(device, sharding)
    fields = {name: torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                                 device=device)
              for name, dtype in _TENSOR_FIELDS.items()}
    fields.update({name: cast(np.asarray(arrays[name]).item())
                   for name, cast in _HOST_FIELDS.items()})
    state = SMCState(**fields)
    return state if sharding is None else shard_state(state, sharding)


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


def distribution_from_numpy(name, params, basis=None):
    """The port's distribution of class ``name`` from the parameters of
    the JAX distribution of that name, as NumPy arrays or numbers under
    its attribute names (e.g. ``{"mean": m, "cov": c}`` for a
    ``MultivariateNormalDistribution``). ``InterpolatedUnivariate
    Distribution`` takes its grid (``xs``, ``cdf``), not its pdf;
    ``GADFLIDistribution`` takes ``fiducial_embedded``, ``alpha``,
    ``beta`` and ``rank`` and needs the port's ``basis``. Other classes
    take their constructor's arguments."""
    p = {k: (v if v is None or isinstance(v, tuple) else np.asarray(v))
         for k, v in params.items()}
    if name == "InterpolatedUnivariateDistribution":
        return distributions.InterpolatedUnivariateDistribution.from_grid(
            p["xs"], p["cdf"])
    if name == "GADFLIDistribution":
        d = basis.dim
        fe = p["fiducial_embedded"]
        rank = p.get("rank")
        return GADFLIDistribution(basis, fe[:d, :d] + 1j * fe[d:, :d],
                                  float(p["alpha"]), float(p["beta"]),
                                  None if rank is None else int(rank))
    return getattr(distributions, name)(**{
        k: (v.item() if isinstance(v, np.ndarray) and v.ndim == 0 else v)
        for k, v in p.items()})


def gaussian_random_walk_from_numpy(underlying_model, step_cov, diagonal,
                                    model_mu_sigma):
    """The port's :class:`GaussianRandomWalkModel` over the port's
    ``underlying_model`` from a JAX walk's step covariance
    (``np.asarray(jax_model.step_distribution.cov)``), ``diagonal`` and
    ``model_mu_sigma``."""
    cov = np.asarray(step_cov, dtype=np.float64)
    scale = np.sqrt(np.diag(cov)) if diagonal else cov
    return GaussianRandomWalkModel(underlying_model, scale=scale,
                                   diagonal=diagonal,
                                   model_mu_sigma=model_mu_sigma)
