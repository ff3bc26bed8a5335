#!/usr/bin/env python3
"""Times two checkouts' kernels on one card, in turns: A, B, B, A.

    python3 scripts/chip_kernel_ab.py PARENT_DIR CHANGE_DIR [--out DIR]

Each turn is a fresh process that builds that checkout's CUDA kernels and
runs its own ``chip_smoke.kernel_phase`` (every kernel held bit for bit
against its plain version, then timed: medians of CUDA-event times with L2
flushed).  The timing lines of each turn are printed with the turn's
label; the whole log of each turn goes to ``DIR/ab_<n>_<label>.log``
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
"""
KEEP = ("scatter_add (", "scatter_add:", "block_topk r=", "block_topk:",
        "block_topk rows launch")


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
