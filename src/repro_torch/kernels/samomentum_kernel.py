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
    """u, g: flat (n,); thr: one-element f32 tensor on the same device.
    Returns (out, u_new).  CPU -> plain version, CUDA -> the kernel."""
    if u.dim() != 1 or g.shape != u.shape or thr.numel() != 1:
        raise ValueError(f"samomentum_fused_flat: shapes {tuple(u.shape)}, "
                         f"{tuple(g.shape)}, {tuple(thr.shape)}")
    if u.device.type == "cpu":
        return samomentum_plain(u, g, thr.reshape(()), momentum=momentum,
                                lr=lr)
    if u.device.type != "cuda":
        raise ValueError(f"samomentum_fused_flat: no kernel for {u.device}")
    for name, t in (("u", u), ("g", g), ("thr", thr)):
        build.require(t, name, torch.float32, u.device)
    out = torch.empty_like(u)
    u_new = torch.empty_like(u)
    rc = build.library().samomentum_fused(
        u.data_ptr(), g.data_ptr(), thr.data_ptr(), out.data_ptr(),
        u_new.data_ptr(), float(np.float32(momentum)),
        float(np.float32(lr)), rcp(momentum), u.numel(), build.stream())
    build.check(rc, INFO.name)
    INFO.launches += 1
    return out, u_new
