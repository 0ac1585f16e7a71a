"""The program's hand-written kernels as the traced run sees them: the
kernel's symbol in the device trace, the program's op that launches it
(observed at its boundary for the call's shape, in the traced run only),
and the call's least time on the card (:mod:`.roofline`)."""

from __future__ import annotations

import dataclasses
import functools
import importlib

from . import roofline


def _k1(call):
    (n,) = call
    return roofline.bound(roofline.k1_bytes(n), 0)[0]


def _k3(call):
    rows, d = call
    return roofline.bound(roofline.k3_fixed_bytes(rows, d), 0)[0]


def _k5(call):
    rows, d, sweeps = call
    return roofline.bound(roofline.jacobi_bytes(rows, d, True),
                          roofline.jacobi_ops(rows, d, sweeps, True))[0]


@dataclasses.dataclass(frozen=True)
class Kernel:
    #: the kernel's demangled symbol starts with this (after ``void ``)
    symbol: str
    #: the program's attributes through which the op is called
    sites: tuple
    #: the call's shape from the op's arguments
    shape: object
    #: the call's least time (s) from its shape
    bound_s: object


KERNELS = {
    "K1": Kernel("precession_update_kernel",
                 ("qinfer_tpu_torch.ops.accelerated.fused_precession_update",),
                 lambda a, kw: (int(a[0].shape[0]),), _k1),
    "K3": Kernel("streaming_resample_kernel",
                 ("qinfer_tpu_torch.resamplers.streaming_resample_locations",),
                 lambda a, kw: (int(a[2].shape[0]), int(a[2].shape[1])), _k3),
    "K5": Kernel("jacobi_warp_kernel<32,1,true>",
                 ("qinfer_tpu_torch.tomography.models."
                  "jacobi_project_lanes_looped",),
                 lambda a, kw: (int(a[0].shape[0]), int(a[0].shape[-1]),
                                int(kw.get("sweeps", a[1] if len(a) > 1
                                           else 6))), _k5),
}


def symbol_of(name):
    """A kernel's name as the trace gives it, without its arguments and
    without spaces after commas (the kernels sit in anonymous namespaces,
    so the symbol is looked for inside it, see :func:`is_kernel`)."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].replace(", ", ",")


def is_kernel(kernel, name):
    base = symbol_of(name)
    return (base.startswith(kernel.symbol)
            or "::" + kernel.symbol in base or " " + kernel.symbol in base)


class Observer:
    """Records each call's shape at the ops' boundaries while installed;
    the program's functions are restored by :meth:`remove`."""

    def __init__(self, kernels=KERNELS):
        self.kernels = kernels
        self.calls = {k: [] for k in kernels}
        self._saved = []

    def install(self):
        for key, kernel in self.kernels.items():
            for site in kernel.sites:
                mod_name, attr = site.rsplit(".", 1)
                try:
                    module = importlib.import_module(mod_name)
                    original = getattr(module, attr)
                except (ImportError, AttributeError):
                    continue
                self._saved.append((module, attr, original))
                setattr(module, attr, self._wrap(key, kernel, original))
        return self

    def _wrap(self, key, kernel, original):
        calls = self.calls[key]

        @functools.wraps(original)
        def observed(*args, **kwargs):
            calls.append(kernel.shape(args, kwargs))
            return original(*args, **kwargs)

        return observed

    def remove(self):
        for module, attr, original in reversed(self._saved):
            setattr(module, attr, original)
        self._saved = []
