#!/usr/bin/env python3
"""Times two checkouts' kernels on one card, in turns: A, B, B, A.

    python3 scripts/chip_kernel_ab.py PARENT_DIR CHANGE_DIR [--out DIR]

Each turn is a fresh process that builds that checkout's CUDA kernels and
runs its own ``chip_smoke.kernel_phase`` (every kernel held bit for bit
against its plain version, then timed), then times, through the
checkout's own public functions (the same calls in both trees), rows 5
and 6 of the kernel table as the port's callers make them:
``wire_pack.quantize_pack`` (scales, codes, shipped values, tern packed)
at a phase B message (k = 10,514 in 8 segments) and at one
4,718,592-element vector, in bf16, int8 and tern; the simulator's
``sparsify.quantize_segments`` at the message and at a (16, k) batch of
messages (phase C's shape); and a message's whole ``wire.pack_from_arena``
in every mode, with its host time per call (its waits included) and the
device kernels, copies and device time per encode from ``torch.profiler``.
Medians of CUDA-event times with L2 flushed (``chip_smoke.Timer``), on
seeded normal values with +-0.  The timing lines of each turn are printed
with the turn's label; the whole log of each turn goes to
``DIR/ab_<n>_<label>.log`` (default ``build/kernel_ab``).  Comparing the
two checkouts inside one call keeps them on one card, under one power
limit.  Needs the card; exits nonzero if any turn fails.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

TURN = """
import sys, time, torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke
from torch.profiler import ProfilerActivity, profile
from repro_torch.cluster import wire
from repro_torch.core.sparsify import SparseLeaf, quantize_segments
from repro_torch.kernels import build, wire_pack
build.library()
timer = chip_smoke.Timer(torch)
rate = chip_smoke.card_rate(torch.cuda.get_device_name(0))
results = []
chip_smoke.kernel_phase(torch, timer, rate, results)
torch.cuda.synchronize()
gen = torch.Generator(device="cuda").manual_seed(5)
space = chip_smoke.full_width_space(torch)
seg = tuple(space.ks(0.001))
k, n_vec = sum(seg), 2304 * 2048


def normal(*shape):
    x = torch.randn(*shape, generator=gen, device="cuda")
    x[..., ::9] = 0.0
    x[..., 4::17] = -0.0
    return x


msg, vec, batch = normal(k), normal(n_vec), normal(16, k)
for mode in ("bf16", "int8", "tern"):
    for label, x, sg in (("message", msg, seg), ("vector", vec, (n_vec,))):
        ms = timer(lambda: wire_pack.quantize_pack(x, mode=mode, seg=sg))
        host = chip_smoke.host_us(
            torch, lambda: wire_pack.quantize_pack(x, mode=mode, seg=sg))
        print(f"ab quantize_pack {label} {mode}: {ms:.4f} ms, host "
              f"{host:.1f} us a call")
    for label, x in (("message", msg), ("batch (16, k)", batch)):
        ms = timer(lambda: quantize_segments(x, mode, seg))
        host = chip_smoke.host_us(torch,
                                  lambda: quantize_segments(x, mode, seg))
        print(f"ab quantize_segments {label} {mode}: {ms:.4f} ms, host "
              f"{host:.1f} us a call")
idx = torch.randperm(space.total, generator=gen, device="cuda")[:k]
leaf = SparseLeaf(msg, idx.sort().values.to(torch.int32), space.total)
for mode in ("none", "bf16", "int8", "tern"):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        wire.pack_from_arena(leaf, mode, seg)
    us = (time.perf_counter() - t0) / 100 * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            wire.pack_from_arena(leaf, mode, seg)
        torch.cuda.synchronize()
    dev = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA
           and a.self_device_time_total > 0]
    kernels = sum(a.count for a in dev if "Memcpy" not in a.key) / 10
    copies = sum(a.count for a in dev if "Memcpy" in a.key) / 10
    busy = sum(a.self_device_time_total for a in dev) / 10
    print(f"ab pack_from_arena {mode}: {us:.1f} us a call, {kernels:.1f} "
          f"device kernels, {copies:.1f} copies, {busy:.1f} us device time "
          f"per encode")
"""
KEEP = ("scatter_add (", "scatter_add:", "block_topk r=", "block_topk:",
        "block_topk rows launch", "row_topk (", "row_topk:",
        "samomentum_row_topk (", "samomentum_row_topk:",
        "samomentum_fused", "scatter_add_rows", "samomentum_accumulate",
        "fma", "wire_codes ", "wire_codes:",
        "tern_pack ", "tern_pack:", "segment_quantize ", "segment_quantize:",
        "segment_quantize_tern_pack:", "codec ", "ab ")


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
