"""Per-block top-r candidate selection -- kernel 2 of the port
(``csrc/block_topk.cu``), and its row regime.

Replaces the TPU's argmax-sweep kernel (``repro/kernels/block_topk.py``,
``block_topk_2d``).  For each block of 1024 elements: the r largest |x|,
ties to the lower index, as signed values and block-local indices.  |x| is
the sign-cleared bit pattern: -0 ties +0, denormals rank by magnitude.  One
warp per block; up to ``SELECT_MAX_R`` a radix select and a sort of the
candidates, above it a register and merge sort of the whole block.

The row regime (:func:`row_topk_rows`, counted on ``ROW_INFO``) replaces
no TPU kernel: for a row of at most ``ROW_MAX`` elements it gives the whole
row's exact top-k in one pass -- what the block top-k at r >= k and the
candidate combine (``ops.hierarchical_topk_rows``) give, in the same order
and bits -- one CTA a row, bound by reading the row once (see the source).
:func:`samomentum_row_topk_rows` (counted on ``SAM_ROW_INFO``) runs the
row-wise SAMomentum step around it in the same pass: the velocity
accumulate in registers, the row regime's top-k of it, and the rescale by
the winners written back over the velocity.

Each wrapper takes a CPU tensor to its plain version and launches the
kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.arith import rcp

from . import build
from .samomentum_kernel import velocity_accumulate_plain

BLOCK = 1024     # elements per block
GROUP = 8        # ops pads to whole groups of blocks, as the reference
SELECT_MAX_R = 64   # kSelectMaxR in csrc/block_topk.cu: the regime switch
ROW_MAX = 8192      # kRowMax in csrc/block_topk.cu: the longest row a CTA has

INFO = build.KernelInfo(
    name="block_topk",
    source="src/repro_torch/kernels/csrc/block_topk.cu",
    replaces="src/repro/kernels/block_topk.py:34")
ROW_INFO = build.KernelInfo(
    name="row_topk",
    source="src/repro_torch/kernels/csrc/block_topk.cu",
    replaces="none: the row regime of src/repro/kernels/block_topk.py:34 "
             "with src/repro/kernels/ops.py:57's candidate top-k")
SAM_ROW_INFO = build.KernelInfo(
    name="samomentum_row_topk",
    source="src/repro_torch/kernels/csrc/block_topk.cu",
    replaces="none: src/repro/core/engine.py's row-wise SAMomentum step "
             "(accumulate, row top-k, mask rescale) in one pass")


def block_topk_plain(x2d: torch.Tensor, r: int):
    """Plain PyTorch version: a stable descending sort of |x| per row, which
    orders ties by index exactly as the argmax sweeps do."""
    idx = torch.sort(x2d.abs(), dim=1, descending=True, stable=True)[1][:, :r]
    return torch.gather(x2d, 1, idx), idx.to(torch.int32)


def block_topk_2d(x2d: torch.Tensor, *, r: int):
    """x2d: (nb, BLOCK) -> (vals (nb, r) x.dtype, idx (nb, r) int32 local
    per-block indices).  CPU -> plain version, CUDA -> the kernel."""
    if x2d.dim() != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"block_topk_2d: shape {tuple(x2d.shape)}, "
                         f"expected (nb, {BLOCK})")
    if not 1 <= r <= BLOCK:
        raise ValueError(f"block_topk_2d: r={r} outside [1, {BLOCK}]")
    if x2d.device.type == "cpu":
        return block_topk_plain(x2d, r)
    if x2d.device.type != "cuda":
        raise ValueError(f"block_topk_2d: no kernel for {x2d.device}")
    build.require(x2d, "x2d", torch.float32, x2d.device)
    nb = x2d.shape[0]
    vals = torch.empty((nb, r), dtype=torch.float32, device=x2d.device)
    idx = torch.empty((nb, r), dtype=torch.int32, device=x2d.device)
    rc = build.library().block_topk(x2d.data_ptr(), vals.data_ptr(),
                                    idx.data_ptr(), nb, r, build.stream())
    build.check(rc, INFO.name)
    build.count(INFO)
    return vals, idx


def row_topk_plain(x2d: torch.Tensor, k: int):
    """Plain PyTorch version of the row regime: a stable descending sort of
    |x| per row, the first k (ties to the lower index)."""
    idx = torch.sort(x2d.abs(), dim=1, descending=True, stable=True)[1][:, :k]
    return torch.gather(x2d, 1, idx), idx.to(torch.int32)


def row_topk_rows(x2d: torch.Tensor, k: int):
    """Each row's exact top-k by |x|: x2d ``(S, n)`` with ``n <= ROW_MAX``
    -> (vals ``(S, k)`` x.dtype, idx ``(S, k)`` int32 row-local indices),
    |x| descending, ties to the lower index.  CPU -> plain version, CUDA ->
    the kernel, ONE launch for all rows (rows may lie any stride apart)."""
    if x2d.dim() != 2 or not 1 <= x2d.shape[1] <= ROW_MAX:
        raise ValueError(f"row_topk_rows: shape {tuple(x2d.shape)}, "
                         f"expected (S, n) with 1 <= n <= {ROW_MAX}")
    S, n = x2d.shape
    if not 1 <= k <= n:
        raise ValueError(f"row_topk_rows: k={k} outside [1, {n}]")
    if x2d.device.type == "cpu":
        return row_topk_plain(x2d, k)
    if x2d.device.type != "cuda":
        raise ValueError(f"row_topk_rows: no kernel for {x2d.device}")
    build.require(x2d, "x2d", torch.float32, x2d.device, contiguous=False)
    if x2d.stride(1) != 1:
        x2d = x2d.contiguous()
    vals = torch.empty((S, k), dtype=torch.float32, device=x2d.device)
    idx = torch.empty((S, k), dtype=torch.int32, device=x2d.device)
    if S == 0:
        return vals, idx
    ld = x2d.stride(0) if S > 1 else n
    rc = build.library().row_topk(x2d.data_ptr(), ld, vals.data_ptr(),
                                  idx.data_ptr(), S, n, k, build.stream())
    build.check(rc, ROW_INFO.name)
    build.count(ROW_INFO)
    return vals, idx


def samomentum_row_topk_plain(u2d: torch.Tensor, g2d: torch.Tensor, *,
                              momentum: float, lr: float, k: int):
    """Plain PyTorch version of :func:`samomentum_row_topk_rows`: the chain
    it replaces -- ``uacc = fma(m, u, lr * g)``, :func:`row_topk_plain` of
    ``uacc``, and ``where(sent, uacc, uacc * (1/m))`` by the winners.
    Returns (vals, idx, u_new)."""
    uacc = velocity_accumulate_plain(u2d, g2d, momentum=momentum, lr=lr)
    vals, idx = row_topk_plain(uacc, k)
    sent = torch.zeros(uacc.shape, dtype=torch.bool, device=uacc.device)
    sent.scatter_(1, idx.to(torch.int64), True)
    return vals, idx, torch.where(sent, uacc, uacc * rcp(momentum))


def _row_operand(x, S: int, n: int, what: str):
    """(pointer, row stride) of a float32 ``(S, n)`` operand with unit
    column stride on the card (the stride of one row is its length)."""
    if x.shape != (S, n) or (n > 1 and x.stride(1) != 1):
        raise ValueError(f"samomentum_row_topk_rows: {what} "
                         f"{tuple(x.shape)} stride {tuple(x.stride())}, "
                         f"expected ({S}, {n}) with unit column stride")
    return x.data_ptr(), x.stride(0) if S > 1 else n


def samomentum_row_topk_rows(u2d: torch.Tensor, g2d: torch.Tensor, *,
                             momentum: float, lr: float, k: int,
                             out: torch.Tensor | None = None):
    """The row-wise SAMomentum step of ``(S, n)`` float32 rows, ``n <=
    ROW_MAX``, in one pass: ``uacc = m * u + lr * g`` (``fma(m, u, lr *
    g)``), each row's exact top-k of ``uacc`` as :func:`row_topk_rows`
    gives it, and ``u_new = sent ? uacc : uacc * (1/m)``.  ``lr`` is a
    float, one for all rows.  ``u_new`` is written into ``out`` (``(S,
    n)``, unit column stride; ``u2d`` itself updates the velocity in
    place), or a new tensor when ``out`` is None.
    Returns (vals ``(S, k)``, idx ``(S, k)`` int32, u_new).  CPU -> plain
    version, CUDA -> the kernel, ONE launch for all rows."""
    if u2d.dim() != 2 or not 1 <= u2d.shape[1] <= ROW_MAX \
            or g2d.shape != u2d.shape:
        raise ValueError(f"samomentum_row_topk_rows: shapes "
                         f"{tuple(u2d.shape)}, {tuple(g2d.shape)}, expected "
                         f"(S, n) with 1 <= n <= {ROW_MAX}")
    S, n = u2d.shape
    if not 1 <= k <= n:
        raise ValueError(f"samomentum_row_topk_rows: k={k} outside "
                         f"[1, {n}]")
    if isinstance(lr, torch.Tensor):
        raise ValueError("samomentum_row_topk_rows: lr is a float, one for "
                         "all rows")
    if u2d.device.type == "cpu":
        vals, idx, u_new = samomentum_row_topk_plain(
            u2d, g2d, momentum=momentum, lr=lr, k=k)
        return vals, idx, u_new if out is None else out.copy_(u_new)
    if u2d.device.type != "cuda":
        raise ValueError(f"samomentum_row_topk_rows: no kernel for "
                         f"{u2d.device}")
    dev = u2d.device
    if out is None:
        out = torch.empty((S, n), dtype=torch.float32, device=dev)
    for name, t in (("u2d", u2d), ("g2d", g2d), ("out", out)):
        build.require(t, name, torch.float32, dev, contiguous=False)
    pu, su = _row_operand(u2d, S, n, "u2d")
    pg, sg = _row_operand(g2d, S, n, "g2d")
    po, so = _row_operand(out, S, n, "out")
    vals = torch.empty((S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((S, k), dtype=torch.int32, device=dev)
    if S == 0:
        return vals, idx, out
    rc = build.library().samomentum_row_topk(
        pu, su, pg, sg, po, so, float(lr), momentum, rcp(momentum),
        vals.data_ptr(), idx.data_ptr(), S, n, k, build.stream())
    build.check(rc, SAM_ROW_INFO.name)
    build.count(SAM_ROW_INFO)
    return vals, idx, out
