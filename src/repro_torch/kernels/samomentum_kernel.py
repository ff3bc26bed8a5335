"""Fused SAMomentum pass -- kernel 3 of the port (``csrc/samomentum.cu``).

Replaces the TPU kernel ``repro/kernels/samomentum_kernel.py``
(``samomentum_fused_2d``):

    uacc  = m * u + lr * g
    sent  = |uacc| >= thr          (ties included)
    out   = sent ? uacc : 0
    u_new = sent ? uacc : uacc / m

with the roundings of the reference as XLA compiles it
(``repro_torch.arith``): ``fma(m, u, lr * g)``, and ``uacc * (1/m)``.

The wrapper takes a CPU tensor to :func:`samomentum_plain` and launches the
kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.arith import fma, rcp

from . import build

INFO = build.KernelInfo(
    name="samomentum_fused",
    source="src/repro_torch/kernels/csrc/samomentum.cu",
    replaces="src/repro/kernels/samomentum_kernel.py:28")


def samomentum_plain(u: torch.Tensor, g: torch.Tensor, thr: torch.Tensor,
                     *, momentum: float, lr: float):
    """Plain PyTorch version over tensors of any shape; computes in f32 and
    returns (out, u_new) in ``u.dtype``."""
    uacc = fma(momentum, u.to(torch.float32), lr * g.to(torch.float32))
    sent = uacc.abs() >= thr
    out = torch.where(sent, uacc, torch.zeros_like(uacc))
    u_new = torch.where(sent, uacc, uacc * rcp(momentum))
    return out.to(u.dtype), u_new.to(u.dtype)


def samomentum_fused_flat(u: torch.Tensor, g: torch.Tensor,
                          thr: torch.Tensor, *, momentum: float, lr: float):
    """u, g: flat (n,), the rows of a contiguous (B, n / B) block laid end
    to end; thr: (B,) f32 on the same device, one threshold per row (B = 1
    for a single tensor).  Returns (out, u_new), flat.  CPU -> plain
    version, CUDA -> the kernel."""
    if u.dim() != 1 or g.shape != u.shape or thr.dim() > 1 \
            or thr.numel() == 0 or u.numel() % thr.numel():
        raise ValueError(f"samomentum_fused_flat: shapes {tuple(u.shape)}, "
                         f"{tuple(g.shape)}, {tuple(thr.shape)}")
    n_rows = thr.numel()
    n_row = u.numel() // n_rows
    if u.device.type == "cpu":
        out, u_new = samomentum_plain(
            u.view(n_rows, n_row), g.view(n_rows, n_row),
            thr.reshape(n_rows, 1), momentum=momentum, lr=lr)
        return out.view(-1), u_new.view(-1)
    if u.device.type != "cuda":
        raise ValueError(f"samomentum_fused_flat: no kernel for {u.device}")
    for name, t in (("u", u), ("g", g), ("thr", thr)):
        build.require(t, name, torch.float32, u.device)
    out = torch.empty_like(u)
    u_new = torch.empty_like(u)
    rc = build.library().samomentum_fused(
        u.data_ptr(), g.data_ptr(), thr.data_ptr(), out.data_ptr(),
        u_new.data_ptr(), float(np.float32(momentum)),
        float(np.float32(lr)), rcp(momentum), u.numel(), max(n_row, 1),
        build.stream())
    build.check(rc, INFO.name)
    build.count(INFO)
    return out, u_new
