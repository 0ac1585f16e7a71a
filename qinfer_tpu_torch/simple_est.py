"""One-line estimation from count data (counterpart of
:mod:`qinfer_tpu.simple_est`): ``simple_est_prec`` and ``simple_est_rb``
with the shared ``load_data`` coercion. Both build an
:class:`~qinfer_tpu_torch.smc.SMCUpdater` on the card unless the caller
asks for the CPU, condition it with one ``batch_update`` and return the
posterior mean and covariance as NumPy arrays.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from .config import DEFAULT_DEVICE
from .derived_models import BinomialModel
from .distributions import PostselectedDistribution, UniformDistribution
from .rb import RandomizedBenchmarkingModel
from .smc import SMCUpdater
from .test_models import SimplePrecessionModel

__all__ = ["simple_est_prec", "simple_est_rb", "load_data"]


def load_data(data, n_cols=3):
    """User data as a float64 array with ``n_cols`` columns: a 2-D
    array-like, a CSV path or file-like object, or a pandas DataFrame
    (pandas is imported only if it is installed)."""
    try:
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            data = data.to_numpy()
    except ImportError:
        pass
    if isinstance(data, (str, io.IOBase)) or hasattr(data, "read"):
        data = np.loadtxt(data, delimiter=",", skiprows=0, ndmin=2)
    data = np.asarray(data, dtype=np.float64)
    if data.ndim != 2 or data.shape[1] != n_cols:
        raise ValueError(
            f"expected data with {n_cols} columns, got shape {data.shape}")
    return data


def _finish(updater, return_all):
    mean = updater.est_mean().cpu().numpy()
    cov = updater.est_covariance_mtx().cpu().numpy()
    if return_all:
        return mean, cov, {"updater": updater}
    return mean, cov


def simple_est_prec(data, freq_min=0.0, freq_max=1.0, n_particles=6000,
                    return_all=False, n_meas_max=None, seed=0,
                    device=DEFAULT_DEVICE):
    """Frequency estimate from precession counts: data columns ``(counts,
    t, n_shots)``; ``BinomialModel(SimplePrecessionModel())`` under a
    uniform prior on ``[freq_min, freq_max]``. Returns ``(mean, cov)``, and
    ``{"updater": ...}`` with ``return_all``. Without a CUDA device, pass
    ``device="cpu"``: the default raises there."""
    data = load_data(data)
    counts = data[:, 0].astype(np.int64)
    n_shots = data[:, 2].astype(np.int64)
    cap = int(n_meas_max if n_meas_max is not None else n_shots.max())
    model = BinomialModel(SimplePrecessionModel(min_freq=freq_min),
                          n_meas_max=cap)
    prior = UniformDistribution([[freq_min, freq_max]])
    updater = SMCUpdater(model, n_particles, prior, seed=seed, device=device)
    eps = {"t": torch.as_tensor(data[:, 1], dtype=torch.float32),
           "n_meas": torch.as_tensor(n_shots, dtype=torch.int32)}
    updater.batch_update(torch.as_tensor(counts, dtype=torch.int32), eps)
    return _finish(updater, return_all)


def simple_est_rb(data, interleaved=False, p_min=0.0, p_max=1.0,
                  n_particles=8000, return_all=False, n_meas_max=None,
                  seed=0, device=DEFAULT_DEVICE):
    """Randomized-benchmarking estimate of ``(p, A, B)`` (interleaved:
    ``(p̃, p_ref, A, B)``) from survival counts: data columns ``(counts, m,
    n_shots)``, plus a 0/1 ``reference`` column when interleaved. The
    prior is uniform, postselected on the model's validity (A + B ≤ 1).
    Returns as :func:`simple_est_prec`."""
    data = load_data(data, n_cols=4 if interleaved else 3)
    counts = data[:, 0].astype(np.int64)
    n_shots = data[:, 2].astype(np.int64)
    cap = int(n_meas_max if n_meas_max is not None else n_shots.max())
    rb = RandomizedBenchmarkingModel(interleaved=interleaved)
    model = BinomialModel(rb, n_meas_max=cap)
    ranges = [[p_min, p_max]] * (2 if interleaved else 1) + [[0.0, 1.0]] * 2
    prior = PostselectedDistribution(UniformDistribution(ranges), rb)
    updater = SMCUpdater(model, n_particles, prior, seed=seed, device=device)
    eps = {"m": torch.as_tensor(data[:, 1].astype(np.int64),
                                dtype=torch.int32),
           "n_meas": torch.as_tensor(n_shots, dtype=torch.int32)}
    if interleaved:
        eps["reference"] = torch.as_tensor(data[:, 3], dtype=torch.int32)
    updater.batch_update(torch.as_tensor(counts, dtype=torch.int32), eps)
    return _finish(updater, return_all)
