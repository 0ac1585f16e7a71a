"""Checkpoint and resume of an updater (counterpart of
:mod:`qinfer_tpu.checkpoint`): the engine state, the data and
normalization records, the rejuvenation record (the compressed pool or the
full per-experiment record) with the Robbins-Monro state, and the random
streams, in one ``.npz`` file with the JAX package's array names.

The random stream of the port is a :class:`torch.Generator`, not a key in
the state: ``save_updater`` stores the states of ``updater.generator``
and, where the model draws Monte-Carlo likelihood noise, of its design
generator (``Generator.get_state()``), with the device type each was made
for. A restored updater therefore continues the saved run draw for draw.
A generator's state fits only a generator of the same device type (a
CPU Mersenne twister against a CUDA Philox counter), so loading a
checkpoint into an updater on another device type raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

# the state's arrays are the ones the parity tests carry between packages
from .convert import state_from_numpy as arrays_to_state
from .convert import state_to_numpy as state_to_arrays
from .smc import _pool_key

__all__ = ["state_to_arrays", "arrays_to_state", "save_updater",
           "load_updater"]


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _generator_arrays(name, generator):
    return {f"__{name}_state": generator.get_state().numpy(),
            f"__{name}_device": np.asarray(generator.device.type)}


def _restore_generator(arrays, name, generator):
    """Set ``generator`` from the archive's ``__{name}_state``; the archive
    must have been saved from a generator of the same device type."""
    state = arrays.pop(f"__{name}_state")
    saved = str(arrays.pop(f"__{name}_device"))
    if saved != generator.device.type:
        raise ValueError(
            f"the checkpoint's {name} is a {saved} generator and this "
            f"updater's is a {generator.device.type} one: a generator state "
            f"restores only on its own device type (load into an updater "
            f"on a {saved} device)")
    generator.set_state(torch.from_numpy(np.ascontiguousarray(state)))


def _rejuvenation_record_arrays(updater):
    """The rejuvenation record as flat arrays: the record length, the
    Robbins-Monro state (flagged by whether the source used the adaptive
    kernel), the compressed pool and the full per-experiment record."""
    extra = {"__n_record": np.asarray(updater._n_record, np.int64),
             "__mcmc_adaptive": np.asarray(
                 1 if updater._use_adaptive_kernel else 0, np.int64),
             "__mcmc_log_scale": np.asarray(updater._mcmc_log_scale,
                                            np.float64),
             "__mcmc_adapt_t": np.asarray(updater._mcmc_adapt_t, np.int64)}
    if updater._pool_eps:
        for k in updater._pool_eps[0]:
            extra[f"__pool_eps__{k}"] = np.concatenate(
                [np.atleast_1d(e[k]) for e in updater._pool_eps], axis=0)
        extra["__pool_succ"] = np.asarray(updater._pool_succ, np.float64)
        extra["__pool_trials"] = np.asarray(updater._pool_trials,
                                            np.float64)
    if updater._eps_record:
        for k in updater._eps_record[0]:
            extra[f"__eps_record__{k}"] = np.concatenate(
                [_host(e[k]) for e in updater._eps_record], axis=0)
    return extra


def _restore_rejuvenation_record(updater, arrays):
    """Inverse of :func:`_rejuvenation_record_arrays` (the keys are popped
    from ``arrays``); clears whatever record the target held. A source
    flagged adaptive must carry both halves of its Robbins-Monro state,
    else ``ValueError`` names the missing key (the JAX package raises a
    ``TypeError`` there)."""
    updater._n_record = int(arrays.pop("__n_record", 0))
    src_adaptive = bool(int(arrays.pop("__mcmc_adaptive", 0)))
    ls = arrays.pop("__mcmc_log_scale", None)
    t_ad = arrays.pop("__mcmc_adapt_t", None)
    if src_adaptive:
        for key, value in (("__mcmc_log_scale", ls),
                           ("__mcmc_adapt_t", t_ad)):
            if value is None:
                raise ValueError(
                    f"checkpoint flags an adaptive move kernel but lacks "
                    f"{key}: the archive is truncated")
        if updater._use_adaptive_kernel:
            updater._mcmc_log_scale = float(ls)
            updater._mcmc_adapt_t = int(t_ad)
    pool_keys = [k for k in list(arrays) if k.startswith("__pool_eps__")]
    updater._pool_eps, updater._pool_succ, updater._pool_trials = [], [], []
    updater._pool_index = {}
    if pool_keys:
        fields = {k[len("__pool_eps__"):]: np.asarray(arrays.pop(k))
                  for k in pool_keys}
        succ = np.asarray(arrays.pop("__pool_succ"))
        trials = np.asarray(arrays.pop("__pool_trials"))
        for i in range(succ.shape[0]):
            eps_i = {k: v[i:i + 1] for k, v in fields.items()}
            updater._pool_index[_pool_key(eps_i)] = i
            updater._pool_eps.append(eps_i)
            updater._pool_succ.append(float(succ[i]))
            updater._pool_trials.append(float(trials[i]))
    rec_keys = [k for k in list(arrays) if k.startswith("__eps_record__")]
    updater._eps_record = []
    if rec_keys:
        fields = {k[len("__eps_record__"):]: np.asarray(arrays.pop(k))
                  for k in rec_keys}
        n_rec = next(iter(fields.values())).shape[0]
        updater._eps_record = [
            {k: torch.as_tensor(v[i:i + 1], device=updater.device)
             for k, v in fields.items()} for i in range(n_rec)]
        if updater._n_record == 0:
            updater._n_record = n_rec


def save_updater(path, updater):
    """Checkpoint an updater's inference state (ensemble, records, the
    rejuvenation record and the generators' states) to one ``.npz`` file
    (``np.savez`` appends the extension if missing). Outcomes keep their
    dtype, so a restored record feeds the moves exactly what the saved one
    did."""
    arrays = state_to_arrays(updater.state)
    arrays.update(_rejuvenation_record_arrays(updater))
    arrays.update(_generator_arrays("generator", updater.generator))
    if updater._design_generator is not None:
        arrays.update(_generator_arrays("design_generator",
                                        updater._design_generator))
    nd = int(getattr(updater.model, "outcome_ndim", 0))
    if updater.data_record:
        outs = [_host(o) for o in updater.data_record]
        arrays["__data_record"] = np.stack(
            [o.reshape(-1)[0] if nd == 0 else o.reshape(o.shape[-nd:])
             for o in outs])
    else:
        arrays["__data_record"] = np.zeros((0,), dtype=np.float64)
    arrays["__normalization_record"] = np.asarray(
        updater.normalization_record, dtype=np.float64)
    np.savez(path, **arrays)


def load_updater(path, updater):
    """Restore a :func:`save_updater` checkpoint into an existing updater
    (which supplies the model, prior, resampler and options); every tensor
    lands on the updater's device and the pool's index is rebuilt.
    Returns the updater."""
    try:
        loaded = dict(np.load(path))
    except FileNotFoundError:
        # np.savez appended '.npz' on save; mirror that here
        loaded = dict(np.load(str(path) + ".npz"))
    data_record = loaded.pop("__data_record")
    norm_record = loaded.pop("__normalization_record")
    _restore_rejuvenation_record(updater, loaded)
    _restore_generator(loaded, "generator", updater.generator)
    if "__design_generator_state" in loaded:
        if updater._design_generator is None:
            updater._design_generator = torch.Generator(
                device=updater.device)
        _restore_generator(loaded, "design_generator",
                           updater._design_generator)
    updater.state = arrays_to_state(loaded, device=updater.device)
    updater.data_record = list(data_record)
    updater.normalization_record = [float(x) for x in norm_record]
    updater._n_particles = int(updater.state.weights.shape[0])
    return updater
