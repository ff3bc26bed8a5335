"""The SAMomentum worker step's elementwise passes -- kernel 3 of the port
and its two float32 fused multiply-adds (``csrc/samomentum.cu``).

The fused pass replaces the TPU kernel ``repro/kernels/samomentum_kernel.py``
(``samomentum_fused_2d``):

    uacc  = m * u + lr * g
    sent  = |uacc| >= thr          (ties included)
    out   = sent ? uacc : 0
    u_new = sent ? uacc : uacc / m

with the roundings of the reference as XLA compiles it
(``repro_torch.arith``): ``fma(m, u, lr * g)``, and ``uacc * (1/m)``.

The same source carries the fused multiply-adds XLA compiles around that
kernel in the reference's blockwise step: the velocity accumulate
(:func:`velocity_accumulate`, the pass's first line alone) and a general
``a * b + c`` (:func:`fused_multiply_add`: the repair's epilogue, the
baselines' residuals, the int8 scale).  Their plain versions are
``repro_torch.arith.fma``'s float64 emulation.

Each wrapper takes a CPU tensor to its plain version and launches its
kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.arith import fma, rcp

from . import build

_SOURCE = "src/repro_torch/kernels/csrc/samomentum.cu"
INFO = build.KernelInfo(
    name="samomentum_fused", source=_SOURCE,
    replaces="src/repro/kernels/samomentum_kernel.py:28")
# the kernel's first line, uacc = momentum * u + lr * g
ACC_INFO = build.KernelInfo(
    name="samomentum_accumulate", source=_SOURCE,
    replaces="src/repro/kernels/samomentum_kernel.py:32")
FMA_INFO = build.KernelInfo(
    name="fma", source=_SOURCE,
    replaces="src/repro/kernels/samomentum_kernel.py:32")

# operand kinds of csrc/samomentum.cu: a float, one value per row, full
SCALAR, ROW, FULL = 0, 1, 2


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
    version, CUDA -> the kernel (one read where u and g are one tensor)."""
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
        u_new.data_ptr(), momentum, lr, rcp(momentum), n_rows, n_row,
        build.stream())
    build.check(rc, INFO.name)
    build.count(INFO)
    return out, u_new


def _rows(shape) -> tuple[int, int]:
    """The ``(B, n)`` a result of ``shape`` is computed as: its rows when
    it is 2-D, else one row of all its elements."""
    if len(shape) == 2:
        return shape[0], shape[1]
    n = 1
    for d in shape:
        n *= d
    return 1, n


def _operand(x, shape, device, what: str):
    """One operand of a pass computing a result of ``shape``, as the C
    entry takes it: (pointer, row stride, value, kind).  A float; a
    ``(B, 1)`` column of a 2-D result (one value per row); or a tensor of
    the result's shape -- any row stride and unit column stride when 2-D,
    else contiguous.
    (Floats pass as C floats: ctypes rounds them to float32 as
    ``np.float32`` does.)"""
    if not isinstance(x, torch.Tensor):
        return None, 0, float(x), SCALAR
    if x.dtype is not torch.float32 or x.device != device:
        build.require(x, what, torch.float32, device, contiguous=False)
    if x.shape == shape:
        if len(shape) != 2:
            if x.is_contiguous():
                return x.data_ptr(), 0, 0.0, FULL
        elif x.stride(1) == 1 or shape[1] == 1:
            return x.data_ptr(), x.stride(0), 0.0, FULL
    elif len(shape) == 2 and x.shape == (shape[0], 1):
        return x.data_ptr(), x.stride(0), 0.0, ROW
    raise ValueError(f"{what}: operand {tuple(x.shape)} stride "
                     f"{tuple(x.stride())} for a {tuple(shape)} result")


def velocity_accumulate_plain(u, g, *, momentum: float, lr):
    """Plain version of :func:`velocity_accumulate`: ``fma(m, u, lr * g)``
    with the float64-emulated fused multiply-add."""
    return fma(momentum, u, lr * g)


def velocity_accumulate(u: torch.Tensor, g: torch.Tensor, *,
                        momentum: float, lr) -> torch.Tensor:
    """``m * u + lr * g`` as ``fma(m, u, lr * g)``, a new contiguous
    float32 tensor shaped like ``u``.  ``u`` and ``g`` are ``(B, n)`` views
    with unit column stride (the leaf views of a ``(B, total)`` arena) or
    contiguous tensors of any one shape; ``lr`` is a float or a ``(B, 1)``
    tensor (one learning rate per row).  CPU -> plain version, CUDA -> the
    kernel."""
    if u.device.type == "cpu":
        return velocity_accumulate_plain(u, g, momentum=momentum, lr=lr)
    if u.device.type != "cuda":
        raise ValueError(f"velocity_accumulate: no kernel for {u.device}")
    shape = u.shape
    if g.shape != shape:
        raise ValueError(f"velocity_accumulate: shapes {tuple(shape)}, "
                         f"{tuple(g.shape)}")
    pu, su, _, _ = _operand(u, shape, u.device, "u")
    pg, sg, _, _ = _operand(g, shape, u.device, "g")
    plr, slr, vlr, klr = _operand(lr, shape, u.device, "lr")
    b, n = _rows(shape)
    if klr == FULL and n != 1:      # one element a row is a column
        raise ValueError(f"velocity_accumulate: u {tuple(shape)}, lr "
                         f"{tuple(lr.shape)}")
    out = torch.empty(shape, dtype=torch.float32, device=u.device)
    if b * n:
        rc = build.library().samomentum_accumulate(
            pu, su, pg, sg, plr, slr, vlr, out.data_ptr(), momentum, b, n,
            build.stream())
        build.check(rc, ACC_INFO.name)
        build.count(ACC_INFO)
    return out


def fused_multiply_add_plain(a, b, c) -> torch.Tensor:
    """Plain version of :func:`fused_multiply_add`: ``arith.fma``."""
    return fma(a, b, c)


def fused_multiply_add(a, b, c) -> torch.Tensor:
    """Float32 ``a * b + c`` with ONE rounding, a new contiguous tensor.
    Each operand is a float, a float32 tensor of the result's shape (unit
    column stride when it is 2-D, contiguous otherwise) or a ``(B, 1)``
    column of a 2-D result; the result has the shape of the largest tensor
    operand.  CPU -> plain version, CUDA -> the
    kernel; at least one operand is a tensor."""
    big = None
    for x in (a, b, c):
        if isinstance(x, torch.Tensor) and (big is None
                                            or x.numel() > big.numel()):
            big = x
    if big is None:
        raise TypeError("fused_multiply_add: no tensor operand")
    if big.device.type == "cpu":
        return fused_multiply_add_plain(a, b, c)
    if big.device.type != "cuda":
        raise ValueError(f"fused_multiply_add: no kernel for {big.device}")
    shape = big.shape
    pa, sa, va, ka = _operand(a, shape, big.device, "a")
    pb, sb, vb, kb = _operand(b, shape, big.device, "b")
    pc, sc, vc, kc = _operand(c, shape, big.device, "c")
    out = torch.empty(shape, dtype=torch.float32, device=big.device)
    rows, n = _rows(shape)
    if rows * n:
        rc = build.library().fma_rows(
            pa, sa, va, ka, pb, sb, vb, kb, pc, sc, vc, kc, out.data_ptr(),
            rows, n, build.stream())
        build.check(rc, FMA_INFO.name)
        build.count(FMA_INFO)
    return out
