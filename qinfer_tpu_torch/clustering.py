"""Particle clustering for multimodal posteriors (counterpart of
:mod:`qinfer_tpu.clustering`): ``particle_clusters`` yields DBSCAN
cluster masks of the particle cloud, ``NO_CLUSTER`` labels noise. A host
computation on a copy of the cloud; scikit-learn is imported at call
time."""

from __future__ import annotations

import warnings

import numpy as np

from .metrics import _host, rescaled_distance_mtx

__all__ = ["particle_clusters", "NO_CLUSTER"]

#: DBSCAN's label for noise points
NO_CLUSTER = -1


def particle_clusters(particle_locations, particle_weights=None,
                      eps=0.5, min_particles=5, metric="euclidean",
                      weighted=False, w_pow=0.5, quiet=True):
    """Yield ``(cluster_label, index_mask)`` for each DBSCAN cluster of the
    particle cloud (noise under ``NO_CLUSTER``). ``weighted`` clusters on
    :func:`~qinfer_tpu_torch.metrics.rescaled_distance_mtx`, so heavy
    particles attract clusters."""
    from sklearn.cluster import DBSCAN

    locations = _host(particle_locations)
    if weighted and particle_weights is None:
        raise ValueError("weighted clustering requires particle_weights")
    if weighted:
        dist = rescaled_distance_mtx(particle_weights, locations,
                                     w_pow=w_pow, metric=metric)
        labels = DBSCAN(eps=eps, min_samples=min_particles,
                        metric="precomputed").fit(dist).labels_
    else:
        labels = DBSCAN(eps=eps, min_samples=min_particles,
                        metric=metric).fit(locations).labels_
    if not quiet and (labels == NO_CLUSTER).all():
        warnings.warn("DBSCAN found no clusters; all particles are noise")
    for label in np.unique(labels):
        yield int(label), labels == label
