"""The arithmetic of the plain reference and of its control.

The reference computes in float64. Its control is the same code computed
one precision below the configurations' float32 with TF32 off: float32
with every product of two state values taken as a TF32 tensor core takes
a float32 GEMM's inputs, each operand rounded to TF32's 10-bit mantissa
(round to nearest, ties to even) and the products summed in float32. The
rounding is done here in software, so the control reads the same on any
device.
"""

from __future__ import annotations

import torch

#: float32 bits dropped by TF32 (23 − 10)
_DROPPED = 13
_MASK = -(1 << _DROPPED)  # keeps the sign, exponent and 10 mantissa bits


def tf32_round(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, as float32."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    half = (1 << (_DROPPED - 1)) - 1
    lsb = (bits >> _DROPPED) & 1
    rounded = (bits + half + lsb) & _MASK
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class Arith:
    """The reference's arithmetic: ``"float64"`` (the reference) or
    ``"tf32"`` (its control)."""

    def __init__(self, precision="float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision is float64 or tf32, not "
                             f"{precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else \
            torch.float32

    @property
    def control(self):
        return self.precision == "tf32"

    def cast(self, x):
        return x.to(self.dtype)

    def _in(self, x):
        x = self.cast(x)
        return tf32_round(x) if self.control else x

    def mm(self, a, b):
        """``a @ b``: float64, or TF32 inputs summed in float32."""
        return self._in(a) @ self._in(b)

    def mul(self, a, b):
        """An elementwise product of two state values (the entries of an
        outer product, which a tensor core would take as GEMM inputs)."""
        return self._in(a) * self._in(b)

    def __repr__(self):
        return f"Arith({self.precision!r})"


FLOAT64 = Arith("float64")
TF32 = Arith("tf32")
