"""Decode-while-training on the PyTorch/CUDA port: a live inference
replica fed by sparse diffs (examples/serve_decode.py's configuration).

    PYTHONPATH=src python examples/serve_decode_torch.py              # on the card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

An async DGS training run (4 workers, 120 events, density 0.1) drives the
in-process parameter server while one inference replica, subscribed over
the in-proc transport, answers a batched eval workload between diff
applies.  The coordinator coalesces every committed update into the
replica's residual cursor and ships ONE re-sparsified ARENA frame per
pull (push density 0.25, staleness bound 4), so the replica's accuracy
climbs during the run.  At quiesce the replica SYNCs: its model must be
bit-identical to the server's.  The coordinator also appends a delta
checkpoint of the live arena every 16 events; the chain is restored at
the end and must be bit-identical too.
"""
import argparse
import tempfile

import torch

from repro_torch import kernels
from repro_torch.checkpoint import load_delta_checkpoint
from repro_torch.cluster import run_inprocess
from repro_torch.core import async_sim, make_strategy
from repro_torch.core.paramspace import ParamSpace
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models.mlp import MLP


def _bits(x):
    return x.contiguous().view(torch.int32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--events", type=int, default=120)
    args = ap.parse_args(argv)
    device = args.device

    task = ClassificationTask(n_features=32, n_classes=8, batch_size=32,
                              noise=0.6, seed=0, device=device)
    model = MLP((32, 32, 8), start=1, scale=0.2, seed=0, device=device)
    params0 = model.params()
    evals = task.eval_set(256)
    trajectory = []

    def decode_fn(params, step):
        # the replica's "traffic": one batched forward per diff window, on
        # whatever model version the last applied diff produced
        acc = model.accuracy(params, evals)
        trajectory.append(acc)
        if step % 8 == 0:
            print(f"  [replica] decode {step:>3}  acc={acc:.3f}")

    sched = async_sim.make_schedule(4, args.events, seed=0, hetero=0.8)
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print(f"[train] 4 workers x {args.events} events, dgs d=0.1; "
              f"1 replica at push-density 0.25, max_staleness 4")
        final, hist = run_inprocess(
            make_strategy("dgs", density=0.1, momentum=0.7), model.grad_fn,
            params0, lambda e, k: task.batch(int(e), int(k)),
            schedule=sched, lr=0.1, secondary_density=0.2,
            n_replicas=1, push_density=0.25, max_staleness=4,
            replica_decode_fn=decode_fn, ckpt_dir=ckpt_dir, ckpt_every=16)
        arena = ParamSpace.from_tree(params0).pack(final)
        rep = hist.metrics["replicas"][0]
        ck, ck_version, _ = load_delta_checkpoint(ckpt_dir,
                                                  device=arena.device)

    same_replica = torch.equal(_bits(rep["arena"]), _bits(arena))
    same_chain = torch.equal(_bits(ck), _bits(arena))
    print(f"[train]   loss {hist.losses[:3].mean():.4f} -> "
          f"{hist.losses[-3:].mean():.4f}  ({len(hist.losses)} events)")
    print(f"[replica] acc  {trajectory[0]:.3f} -> {trajectory[-1]:.3f}  "
          f"over {rep['decodes']} decode boundaries, {rep['diffs']} diffs, "
          f"{rep['bytes_in']} push bytes")
    print(f"[replica] final model bit-identical to server: {same_replica} "
          f"(version {rep['version']})")
    print(f"[ckpt]    delta-chain restore bit-identical: {same_chain} "
          f"(version {ck_version})")
    launches = {info.name: info.launches for info in kernels.KERNELS}
    print(f"kernel launches: {launches}")
    if not (same_replica and same_chain):
        raise AssertionError("the replica or the restored chain differs "
                             "from the server's final arena")
    return {"hist": hist, "arena": arena, "replica": rep, "chain": ck,
            "chain_version": ck_version, "launches": launches}


if __name__ == "__main__":
    main()
