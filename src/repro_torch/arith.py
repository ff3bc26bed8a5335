"""The reference's float32 arithmetic, reproduced rounding for rounding.

The JAX package's numbers are what XLA compiles its expressions to, and on
the CPU that is not one rounding per written operator:

* ``a * b + c`` inside one fused computation becomes ONE fused
  multiply-add, ``fma(a, b, c)``.  For ``m * u + lr * g`` it is
  ``fma(m, u, lr * g)``; for ``r + lr * g`` it is ``fma(lr, g, r)``.
* ``x / c`` by a compile-time constant becomes ``x * (1 / c)``, the
  reciprocal rounded to float32 first.

PyTorch runs one rounding per operator, so the port spells these forms out
with :func:`fma` and :func:`rcp`.  The CUDA kernels use the matching
intrinsics (``__fmaf_rn``, ``__fmul_rn``), so a kernel, its plain version
and the reference agree bit for bit.  :func:`fma` is the plain version of
the float32 fused multiply-add kernel
(``kernels.samomentum_kernel.fused_multiply_add``), which its callers take
on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def rcp(c: float) -> float:
    """``1 / c`` rounded in float32, as XLA folds a constant divisor."""
    return float(np.float32(1.0) / np.float32(c))


def fma(a, b, c) -> torch.Tensor:
    """Float32 ``a * b + c`` with ONE rounding, on any device.

    ``a * b`` is exact in float64 (two 24-bit significands fit in 53), and
    the float64 sum is rounded to odd, which makes the final rounding to
    float32 the correctly rounded fused result (53 >= 2 * 24 + 2).
    ``a``, ``b``, ``c`` are float32 tensors or Python floats (taken as
    their float32 value); the result is float32.
    """
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))

    def wide(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        # a fill, not a host-to-device copy: no sync on the card
        return torch.full((), float(np.float32(x)), dtype=torch.float64,
                          device=ref.device)

    p = wide(a) * wide(b)
    c64 = wide(c)
    s = p + c64
    # two-sum error of the float64 addition: s + e == p + c exactly
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    inexact = e != 0
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(inexact & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)
