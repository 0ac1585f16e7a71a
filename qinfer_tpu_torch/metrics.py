"""Distance metrics for weighted particle clouds (counterpart of
:mod:`qinfer_tpu.metrics`): ``rescaled_distance_mtx``, the weighted
pairwise distances that :mod:`qinfer_tpu_torch.clustering` clusters on.
Host computations: tensors are copied to NumPy, and scipy is imported at
call time."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rescaled_distance_mtx", "weighted_pairwise_distances"]


def _host(x):
    """A tensor or array-like as a NumPy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def rescaled_distance_mtx(weights, locations, w_pow=0.5, metric="euclidean"):
    """Pairwise distances rescaled by the particle weights:
    ``D_ij = d(x_i, x_j) / (n² w_i w_j)^{w_pow}``. Heavy pairs look
    closer, so clusters form around posterior mass; uniform weights leave
    the distances unchanged. (n, n) NumPy float64."""
    from scipy.spatial.distance import pdist, squareform

    locations = _host(locations)
    weights = _host(weights)
    base = squareform(pdist(locations, metric=metric))
    n = weights.shape[0]
    scale = (n * n * np.multiply.outer(weights, weights)) ** w_pow
    # no division blow-up for (numerically) zero-weight particles
    scale = np.clip(scale, np.finfo(float).tiny ** 0.5, None)
    return base / scale


def weighted_pairwise_distances(weights, locations, w_pow=0.5,
                                metric="euclidean"):
    """Another name of :func:`rescaled_distance_mtx`."""
    return rescaled_distance_mtx(weights, locations, w_pow=w_pow,
                                 metric=metric)
