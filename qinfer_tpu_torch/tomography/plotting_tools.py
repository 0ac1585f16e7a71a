"""Tomography plots (counterpart of
:mod:`qinfer_tpu.tomography.plotting_tools`): the posterior cloud in the
rebit disk and the spaghetti plot of randomized-benchmarking decays. Host
plots of copies of the posterior; matplotlib is imported at call time."""

from __future__ import annotations

import numpy as np
import torch

from ..abstract_model import atleast_2d

__all__ = ["plot_rebit_posterior", "plot_decaying_exponentials",
           "rebit_coords"]


def rebit_coords(model, modelparams, rebit_axes=(1, 3)):
    """(⟨X⟩, ⟨Z⟩) rebit-plane coordinates of a particle batch, (n, 2)
    NumPy. ``rebit_axes`` index the FULL coordinates (the identity is 0),
    so the default ``(1, 3)`` picks X and Z of a Pauli basis: the two axes
    a rebit (a real density matrix, ⟨Y⟩ = 0) lives on. A coordinate is
    Tr(B_i ρ) with B = σ/√d, so ⟨σ_i⟩ = √d · coordinate."""
    x = torch.as_tensor(modelparams)
    coords = model._full_coords(atleast_2d(x)).detach().cpu().numpy()
    return np.sqrt(model.dim) * coords[:, list(rebit_axes)]


def plot_rebit_posterior(updater, prior=None, true_state=None, n_std=3,
                         level=0.95, rebit_axes=(1, 3), ax=None):
    """Scatter the posterior cloud in the rebit (x, z) disk (marker area ∝
    weight), with its ``n_std``-sd ellipse, 300 draws of ``prior`` and the
    true state when given. Returns the axes."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle, Ellipse

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    model = updater.model
    pts = rebit_coords(model, updater.particle_locations, rebit_axes)
    w = updater.particle_weights.detach().cpu().numpy().astype(np.float64)
    ax.add_patch(Circle((0, 0), 1.0, fill=False, color="k", lw=1))
    if prior is not None:
        g = torch.Generator(device=updater.device)
        g.manual_seed(0)
        prior_pts = rebit_coords(model, prior.sample(g, 300), rebit_axes)
        ax.scatter(prior_pts[:, 0], prior_pts[:, 1], s=2, alpha=0.15,
                   color="0.6", label="prior")
    ax.scatter(pts[:, 0], pts[:, 1], s=1e3 * w, alpha=0.3,
               label="posterior")
    w = w / w.sum()
    mean = w @ pts
    xc = pts - mean
    cov = (xc * w[:, None]).T @ xc
    evals, evecs = np.linalg.eigh(cov)
    angle = np.degrees(np.arctan2(evecs[1, -1], evecs[0, -1]))
    ax.add_patch(Ellipse(mean, 2 * n_std * np.sqrt(evals[-1]),
                         2 * n_std * np.sqrt(evals[0]), angle=angle,
                         fill=False, color="C1",
                         label=f"{n_std}σ region"))
    if true_state is not None:
        true_mps = model.states_to_modelparams(
            np.asarray(true_state)[None])[0]
        tp = rebit_coords(model, true_mps[None], rebit_axes)
        ax.scatter(tp[:, 0], tp[:, 1], marker="*", s=200, color="C3",
                   label="true", zorder=5)
    ax.set_xlim(-1.1, 1.1)
    ax.set_ylim(-1.1, 1.1)
    ax.set_xlabel(r"$\langle X \rangle$")
    ax.set_ylabel(r"$\langle Z \rangle$")
    ax.legend(loc="upper right", fontsize=8)
    return ax


def plot_decaying_exponentials(updater, ms=None, true_modelparams=None,
                               n_curves=50, ax=None):
    """Spaghetti plot of ``n_curves`` posterior draws of the RB survival
    curve A pᵐ + B against the sequence length m, with the true curve when
    given. Returns the axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    if ms is None:
        ms = np.unique(np.logspace(0, 3, 50).astype(int))
    samples = updater.sample(n_curves).detach().cpu().numpy()
    for row in samples:
        p, A, B = row[:3]
        ax.plot(ms, A * p ** ms + B, alpha=0.1, color="C0")
    if true_modelparams is not None:
        p, A, B = np.asarray(true_modelparams).ravel()[:3]
        ax.plot(ms, A * p ** ms + B, color="C3", lw=2, label="true")
        ax.legend()
    ax.set_xscale("log")
    ax.set_xlabel("sequence length m")
    ax.set_ylabel("survival probability")
    return ax
