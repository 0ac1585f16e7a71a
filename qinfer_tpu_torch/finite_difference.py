"""Central finite-difference gradients (counterpart of
:mod:`qinfer_tpu.finite_difference`), NumPy on the host: the CG
experiment designer's gradient of a black-box objective."""

from __future__ import annotations

import numpy as np

__all__ = ["FiniteDifference"]


class FiniteDifference:
    """Functor approximating the gradient of ``func`` by central
    differences: calling it on a point of ``n_args`` coordinates returns
    the gradient estimate, step ``h`` (a number or one per coordinate)."""

    def __init__(self, func, n_args, h=1e-6):
        self.func = func
        self.n_args = int(n_args)
        self.h = np.broadcast_to(np.asarray(h, dtype=float),
                                 (self.n_args,)).copy()

    def central(self, x):
        x = np.asarray(x, dtype=float).reshape(self.n_args)
        grad = np.empty(self.n_args)
        for i in range(self.n_args):
            dx = np.zeros(self.n_args)
            dx[i] = self.h[i]
            grad[i] = (np.asarray(self.func(x + dx))
                       - np.asarray(self.func(x - dx))) / (2 * self.h[i])
        return grad

    __call__ = central
