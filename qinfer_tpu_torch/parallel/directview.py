"""Likelihood evaluation over a pool of engines (counterpart of
:mod:`qinfer_tpu.parallel.directview`, after the reference package's
``DirectViewParallelizedModel``).

The model's particles are split along the model-parameter axis into one
chunk an engine of a DirectView-like object (``__len__``, ``apply`` and
optionally ``purge_results``); each engine evaluates the serial model's
likelihood on its chunk and the results are joined in order. Below
``serial_threshold`` particles, or with one engine, the serial model runs
alone. Unlike the JAX package, a failing ``apply`` is not answered by a
serial evaluation: the error propagates (a pool that fails is a fault to
see, not to hide).
"""

from __future__ import annotations

import torch

from ..abstract_model import atleast_2d
from ..derived_models import DerivedModel

__all__ = ["DirectViewParallelizedModel"]


class DirectViewParallelizedModel(DerivedModel):
    """Parallelize ``likelihood`` over the model-parameter axis through a
    DirectView-like executor.

    :param serial_model: the model evaluated on each chunk.
    :param direct_view: ``len(view)`` engines; ``view.apply(f, chunk)``
        returns ``f(chunk)`` or a handle with ``get()``.
    :param bool purge_client: call ``view.purge_results('all')`` after each
        evaluation.
    :param int serial_threshold: at or below this many particles the
        serial model runs alone (default 10 per engine).
    """

    #: the likelihood leaves the process's own device work for a pool
    host_only = True

    def __init__(self, serial_model, direct_view, purge_client=False,
                 serial_threshold=None):
        super().__init__(serial_model)
        self.direct_view = direct_view
        self.purge_client = bool(purge_client)
        self.serial_threshold = (int(serial_threshold)
                                 if serial_threshold is not None
                                 else 10 * self.n_engines)

    @property
    def n_engines(self):
        """Engines behind the view (1 for a view without a length)."""
        try:
            return max(1, len(self.direct_view))
        except TypeError:
            return 1

    def likelihood(self, outcomes, modelparams, expparams):
        """(n_outcomes, n_models, n_experiments), on the particles'
        device."""
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        serial = self.underlying_model
        if (modelparams.shape[0] <= self.serial_threshold
                or self.n_engines == 1):
            return serial.likelihood(outcomes, modelparams, expparams)

        def eval_chunk(chunk):
            return serial.likelihood(outcomes, chunk, expparams)

        try:
            results = [self.direct_view.apply(eval_chunk, chunk) for chunk
                       in torch.tensor_split(modelparams, self.n_engines)]
            results = [r.get() if hasattr(r, "get") else r for r in results]
        finally:
            if self.purge_client and hasattr(self.direct_view,
                                             "purge_results"):
                self.direct_view.purge_results("all")
        return torch.cat([torch.as_tensor(r, device=modelparams.device)
                          for r in results], dim=1)
