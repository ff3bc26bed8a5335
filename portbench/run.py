"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 portbench/run.py --workload chatglm3-6b.allgather.s128 \
        --seed 7 --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics with the device's busy time and a breakdown.  Each
number of the correctness check is printed beside its limit as the last
lines of standard error and under ``check``, the result's last key.  The
run needs a CUDA device and exits with 2 without one; it exits with 3,
printing no result, when the JAX stack or the JAX package was loaded.
Kernel builds and caches stay in ``build/`` of the checkout.  The run
keeps to two cores and one intra-op thread.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process on few threads: the host work of a step is Python and
    # kernel launches, and a run that migrates over all the cores or
    # wakes a pool of threads spreads more from run to run
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-2:])
    # the package, never this folder, is what imports find
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)

    import torch

    from portbench import guard, harness

    torch.set_num_threads(1)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, bench)
    result = harness.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda",
                         t_start=T_START)
    found = guard.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
