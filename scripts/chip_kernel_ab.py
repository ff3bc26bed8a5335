#!/usr/bin/env python3
"""Times two checkouts' kernels on one card, in turns: A, B, B, A.

    python3 scripts/chip_kernel_ab.py PARENT_DIR CHANGE_DIR [--out DIR]

Each turn is a fresh process that builds that checkout's CUDA kernels and
runs its own ``chip_smoke.kernel_phase`` (every kernel held bit for bit
against its plain version, then timed: medians of CUDA-event times with L2
flushed), then times, through each checkout's own functions, the calls
whose older design an older kernel phase does not time: the multi-row
scatter-add at the blockwise repair's one lane (1 x 4,718,592, k = 4,719),
and the velocity accumulate and the repair's fused multiply-add on the
eight leaves of phase B's arena (one event's calls, with the number of
device kernels they launch).  The timing lines of
each turn are printed with the turn's label; the whole log of each turn goes to ``DIR/ab_<n>_<label>.log``
(default ``build/kernel_ab``).
Comparing the two checkouts inside one call keeps them on one card, under
one power limit.  Needs the card; exits nonzero if any turn fails.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

TURN = """
import sys, torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke
from repro_torch.kernels import build
build.library()
timer = chip_smoke.Timer(torch)
rate = chip_smoke.card_rate(torch.cuda.get_device_name(0))
results = []
chip_smoke.kernel_phase(torch, timer, rate, results)
torch.cuda.synchronize()

from repro_torch import arith
from repro_torch.core import engine
from repro_torch.kernels import samomentum_kernel, scatter_apply
gen = torch.Generator(device="cuda").manual_seed(1)
n1, k1 = 2304 * 2048, 4719
d1 = torch.randn(1, n1, generator=gen, device="cuda")
i1 = torch.randperm(n1, generator=gen, device="cuda")[:k1]
i1 = i1.to(torch.int32)[None]
v1 = torch.randn(1, k1, generator=gen, device="cuda")
# the repair's rows: None (the identity) where the wrapper takes it
rows = None if hasattr(scatter_apply, "MAX_LANES") else range(1)
ms = timer(lambda: scatter_apply.scatter_add_rows_(d1, rows, i1, v1))
print(f"ab scatter_add_rows B=1 (1 x {n1}, k={k1}): wrapper {ms:.4f} ms")
sizes = {}
dims = chip_smoke.FULL_DIMS
for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
    sizes[f"w{i}"], sizes[f"b{i}"] = a * b, b
layout, off = [], 0
for key in sorted(sizes):
    layout.append((off, sizes[key]))
    off += sizes[key]
u, g = (torch.randn(1, off, generator=gen, device="cuda") for _ in "ug")
lr1 = torch.full((1, 1), 0.05, device="cuda")
views = [(u[:, o:o + s], g[:, o:o + s]) for o, s in layout]
ms = timer(lambda: [engine.velocity_accumulate(a, b, momentum=0.7, lr=lr1)
                    for a, b in views])
print(f"ab velocity_accumulate (8 leaves, {off} elements): {ms:.4f} ms")
fma = getattr(samomentum_kernel, "fused_multiply_add", arith.fma)
extra = [torch.randn(1, s, generator=gen, device="cuda") for _, s in layout]
u_new = [torch.randn(1, s, generator=gen, device="cuda") for _, s in layout]
ms = timer(lambda: [fma(e, 1.0 / 0.7 - 1.0, w) for e, w in zip(extra, u_new)])
print(f"ab repair fma (8 leaves, {off} elements): {ms:.4f} ms")
from torch.profiler import ProfilerActivity, profile
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for a, b in views:
        engine.velocity_accumulate(a, b, momentum=0.7, lr=lr1)
    for e, w in zip(extra, u_new):
        fma(e, 1.0 / 0.7 - 1.0, w)
    torch.cuda.synchronize()
kernels = sum(a.count for a in prof.key_averages()
              if a.device_type == torch.autograd.DeviceType.CUDA
              and a.self_device_time_total > 0)
print(f"ab device kernels of one event's accumulates and repair fmas: "
      f"{kernels}")
"""
KEEP = ("scatter_add (", "scatter_add:", "block_topk r=", "block_topk:",
        "block_topk rows launch", "samomentum_fused", "scatter_add_rows",
        "samomentum_accumulate", "fma", "ab ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=Path, help="first checkout (the parent)")
    ap.add_argument("b", type=Path, help="second checkout (the change)")
    ap.add_argument("--out", type=Path, default=Path("build/kernel_ab"))
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    failed = 0
    for n, (label, root) in enumerate((("A", args.a), ("B", args.b),
                                       ("B", args.b), ("A", args.a))):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                              capture_output=True, text=True, timeout=900)
        log = proc.stdout + proc.stderr
        (args.out / f"ab_{n}_{label}.log").write_text(log)
        print(f"== turn {n} {label} ({root}): exit {proc.returncode}",
              flush=True)
        for line in log.splitlines():
            if line.strip().startswith(KEEP):
                print(f"  {label}{n} {line.strip()}", flush=True)
        failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
