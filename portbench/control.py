"""The readings that the comparison's limits are set from, for one cell
on many seeds in one process, at the cell's own sizes (no window):

    python3 portbench/control.py --workload chatglm3-6b.allgather.s128 \
        --kinds sound:11-22,control:31-33

Each kind runs on its inclusive range of seeds.  ``sound`` reads the
program as it is; ``control`` puts the plain
reference, computed in fp8 (the step below the configuration's bf16),
in the program's place; ``half_batch`` and ``no_exchange`` plant those
faults under the program's timed path (``harness.plant``).  One JSON
line a seed on standard output.  The benchmark's own runs do not run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kinds", required=True,
                    help="comma-separated: sound, control, half_batch, "
                         "no_exchange")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for spec in args.kinds.split(","):
        kind, seeds = spec.split(":")
        lo, hi = (int(x) for x in seeds.split("-"))
        if kind not in ("sound", "control", "half_batch", "no_exchange"):
            raise ValueError(f"unknown kind {kind!r}")
        for seed in range(lo, hi + 1):
            t0 = time.perf_counter()
            numbers = harness.readings(
                cell, seed, "cuda",
                fault=kind if kind in ("half_batch", "no_exchange") else None,
                control=kind == "control")
            print(json.dumps({"workload": cell.name, "kind": kind,
                              "seed": seed, **numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
