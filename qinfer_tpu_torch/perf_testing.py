"""Performance-testing harness (counterpart of
:func:`qinfer_tpu.perf_testing.perf_test`): one full adaptive inference
run, heuristic → simulate → update, as a host loop through
:meth:`SMCUpdater.update`, recording loss, timing and resampling per step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .abstract_model import atleast_2d
from .config import DEFAULT_DEVICE, resolve_device
from .heuristics import PGH
from .smc import SMCUpdater

__all__ = ["perf_test", "PERF_DTYPE"]

#: Per-step record dtype (the reference's structured array fields).
PERF_DTYPE = [
    ("elapsed_time", np.float64),
    ("loss", np.float64),
    ("resample_count", np.int64),
    ("outcome", np.float64),
]


def perf_test(model, n_particles, prior, n_exp, heuristic_class=PGH,
              true_model=None, true_prior=None, true_mps=None,
              extra_updater_args=None, seed=0, device=DEFAULT_DEVICE):
    """Run one full adaptive inference experiment and record per-step
    performance.

    Same protocol as the reference: draw the true parameters from
    ``true_prior`` (default: the inference prior) unless ``true_mps`` is
    given, then loop ``heuristic → true_model.simulate_experiment →
    (a time-dependent true model's update_timestep) → updater.update``,
    recording the Q-weighted quadratic loss of the posterior mean against
    the current true parameters, the wall time of the step and the
    resample count.

    ``device`` is the card by default; without a CUDA device, pass
    ``device="cpu"``: the default raises there.

    :return: ``(performance, extra)``: a structured array of length
        ``n_exp`` with fields ``PERF_DTYPE``, and a dict with the
        ``updater``, ``true_mps`` and the per-step estimates ``est``.
    """
    true_model = true_model if true_model is not None else model
    true_prior = true_prior if true_prior is not None else prior
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    if true_mps is None:
        true_mps = true_prior.sample(generator, 1)
    true_mps = atleast_2d(torch.as_tensor(true_mps, dtype=torch.float32,
                                          device=device))

    updater = SMCUpdater(model, n_particles, prior, seed=seed + 1,
                         device=device, **(extra_updater_args or {}))
    heuristic = heuristic_class(updater)

    performance = np.zeros((n_exp,), dtype=PERF_DTYPE)
    ests = np.zeros((n_exp, model.n_modelparams))
    Q = model.Q.numpy()
    time_dependent = bool(true_model.is_time_dependent)

    for idx in range(n_exp):
        t0 = time.perf_counter()
        eps = heuristic(idx)
        outcome = true_model.simulate_experiment(generator, true_mps, eps)
        if time_dependent:
            true_mps = true_model.update_timestep(
                generator, true_mps, eps)[:, :, 0]
        updater.update(outcome, eps)
        est = updater.est_mean().cpu().numpy()
        delta = est - true_mps[0].cpu().numpy()
        performance[idx]["elapsed_time"] = time.perf_counter() - t0
        performance[idx]["loss"] = float(np.sum(Q * delta * delta))
        performance[idx]["resample_count"] = updater.resample_count
        performance[idx]["outcome"] = float(outcome.reshape(-1)[0])
        ests[idx] = est

    extra = {
        "updater": updater,
        "true_mps": true_mps.cpu().numpy(),
        "est": ests,
    }
    return performance, extra
