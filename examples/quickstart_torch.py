"""Quickstart of the PyTorch/CUDA port: DGS + SAMomentum on a simulated
asynchronous PS cluster, at examples/quickstart.py's configuration.

    PYTHONPATH=src python examples/quickstart_torch.py             # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --log-level warning  # silent

Trains a small MLP classifier with 8 asynchronous workers at 99% gradient
sparsity and compares against dense ASGD, then runs DGS again through the
batched event loop (``run_batched``), which must give the same bits.
"""
import argparse

import torch

from repro_torch import telemetry
from repro_torch.core import async_sim, make_strategy
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models.mlp import MLP


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--log-level", default="info",
                    help="debug | info | warning | error")
    args = ap.parse_args()
    telemetry.set_level(args.log_level)
    log = telemetry.get_logger("quickstart")
    device = args.device
    task = ClassificationTask(n_features=64, n_classes=10, batch_size=32,
                              noise=0.8, seed=0, device=device)
    model = MLP((64, 64, 10), start=1, scale=0.18, device=device)
    params0 = model.params()
    schedule = async_sim.make_schedule(n_workers=8, n_events=600, seed=1,
                                       hetero=0.8)
    evals = task.eval_set(1024)
    for name, kwargs in [
        ("asgd", {}),
        ("dgs", {"density": 0.01, "momentum": 0.7}),
    ]:
        trainer = async_sim.AsyncTrainer(
            strategy=make_strategy(name, **kwargs), grad_fn=model.grad_fn,
            n_workers=8, lr=0.1, device=device)
        final, _, hist = trainer.run(
            params0, schedule, lambda e, k: task.batch(e, worker=k))
        log.info(f"{name:6s} acc={model.accuracy(final, evals):.3f} "
              f"up={hist.up_bytes/1e6:6.2f}MB down={hist.down_bytes/1e6:6.2f}MB "
              f"mean_staleness={hist.staleness.mean():.1f}")
    batches = async_sim.batch_schedule(schedule)
    final_b, _, hist_b = trainer.run_batched(
        params0, schedule, lambda e, k: task.batch(e, worker=k))
    same = (hist_b.losses.tolist() == hist.losses.tolist()
            and all(torch.equal(final[k], final_b[k]) for k in final))
    log.info(f"dgs batched: {len(batches)} batches (mean "
          f"{len(schedule) / len(batches):.2f} events), bit-equal to the "
          f"serial loop: {same}")


if __name__ == "__main__":
    main()
