"""Fig. 4-style study on the PyTorch/CUDA port: dual-way sparsification
under constrained bandwidth (examples/bandwidth_study.py's study, which
runs ``benchmarks/bench_bandwidth.py``).

    PYTHONPATH=src python examples/bandwidth_study_torch.py --quick          # on the card
    PYTHONPATH=src python examples/bandwidth_study_torch.py --device cpu

Measures the real per-iteration wire bytes of ASGD against DGS, with and
without secondary compression, and of the codec's bf16, int8 and tern
frames, on the asynchronous simulator (``AsyncTrainer.run`` over
``make_schedule(8, n_events, seed=4, hetero=0.8)``), then models the
wall-clock at 10 Gbps and 1 Gbps, reproducing the mechanism behind the
paper's 5.7x.  The problem is the benchmarks' classification stand-in:
an MLP 64-64-64-10 on gaussian blobs (batch 32, noise 0.6), density
0.01, momentum 0.7, lr 0.08.  The first column of a row is the host's
microseconds an event (synchronized at the end of each run).
"""
import argparse
import time

import torch

from repro_torch import kernels
from repro_torch.core import async_sim, make_strategy
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models.mlp import MLP

GBPS = 1e9 / 8  # bytes per second per Gbps
DENSITY, MOMENTUM, LR, N_WORKERS, SEED = 0.01, 0.7, 0.08, 8, 4


def problem(device):
    """(params0, grad_fn, batch_fn): ``make_classification_problem(seed=0)``
    of the benchmarks, with the port's MLP init."""
    task = ClassificationTask(n_features=64, n_classes=10, batch_size=32,
                              noise=0.6, seed=0, device=device)
    model = MLP((64, 64, 64, 10), seed=0, device=device)
    return model.params(), model.grad_fn, \
        lambda e, k: task.batch(int(e), worker=int(k))


def run_strategy(name, params0, grad_fn, batch_fn, *, n_events,
                 secondary_density=None, quantize="none", device=None):
    """One strategy on the asynchronous simulator, as the benchmarks'
    ``run_strategy``: (final, History, seconds)."""
    kw = {}
    if name != "asgd":
        kw.update(density=DENSITY, quantize=quantize, momentum=MOMENTUM)
    trainer = async_sim.AsyncTrainer(make_strategy(name, **kw), grad_fn,
                                     N_WORKERS, lr=LR,
                                     secondary_density=secondary_density,
                                     device=device)
    sched = async_sim.make_schedule(N_WORKERS, n_events, seed=SEED,
                                    hetero=0.8)
    t0 = time.perf_counter()
    final, _, hist = trainer.run(params0, sched, batch_fn)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return final, hist, time.perf_counter() - t0


def measure(params0, grad_fn, batch_fn, n_events, device=None):
    """The study's measurements: ``{tag: (up, down, seconds)}`` for asgd,
    dgs and dgs+2nd, and for dgs+2nd/bf16, /int8 and /tern."""
    out = {}
    runs = [("asgd", "asgd", None, "none"), ("dgs", "dgs", None, "none"),
            ("dgs+2nd", "dgs", DENSITY, "none")] + [
        (f"dgs+2nd/{mode}", "dgs", DENSITY, mode)
        for mode in ("bf16", "int8", "tern")]
    for tag, name, secondary, mode in runs:
        _, hist, dt = run_strategy(name, params0, grad_fn, batch_fn,
                                   n_events=n_events,
                                   secondary_density=secondary,
                                   quantize=mode, device=device)
        out[tag] = (hist.up_bytes, hist.down_bytes, dt)
    return out


def rows(measured, n_events, n_params):
    """``bench_bandwidth.run``'s rows, ``name,us_per_event,derived``."""
    out = []
    per_iter = {}
    for tag in ("asgd", "dgs", "dgs+2nd"):
        up, down, dt = measured[tag]
        per_iter[tag] = (up + down) / n_events
        out.append(f"fig4/bytes/{tag},{dt / n_events * 1e6:.1f},"
                   f"bytes_per_iter={per_iter[tag]:.0f}")
    for mode in ("bf16", "int8", "tern"):
        up, down, _ = measured[f"dgs+2nd/{mode}"]
        out.append(f"fig4/wire/dgs+2nd/{mode},0.0,"
                   f"up_per_iter={up / n_events:.0f};"
                   f"down_per_iter={down / n_events:.0f}")
    # analytic scale-up: a ResNet-18-sized model (11.7M parameters), fp32
    scale = 11.7e6 / n_params
    t_compute = 0.118  # s/iter on K80 (paper: 50 epochs/88min incl. comm)
    for bw_gbps in (10.0, 1.0):
        times = {tag: t_compute + v * scale / (bw_gbps * GBPS)
                 for tag, v in per_iter.items()}
        speedup = times["asgd"] / times["dgs+2nd"]
        out.append(f"fig4/model_{bw_gbps:g}gbps,0.0,"
                   f"asgd_s={times['asgd']:.3f};dgs_s={times['dgs']:.3f};"
                   f"dgs2nd_s={times['dgs+2nd']:.3f};speedup={speedup:.1f}x")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--quick", action="store_true",
                    help="150 events a run (default 600)")
    args = ap.parse_args(argv)
    n_events = 150 if args.quick else 600
    params0, grad_fn, batch_fn = problem(args.device)
    n_params = sum(v.numel() for v in params0.values())
    kernels.reset_launches()
    measured = measure(params0, grad_fn, batch_fn, n_events, args.device)
    for row in rows(measured, n_events, n_params):
        print(row)
    launches = {info.name: info.launches for info in kernels.KERNELS}
    print(f"kernel launches: {launches}")
    return {"measured": measured, "launches": launches}


if __name__ == "__main__":
    main()
