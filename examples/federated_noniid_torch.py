"""Federated quickstart of the PyTorch/CUDA port: heterogeneous clients,
non-IID data, real wire (examples/federated_noniid.py's configuration).

    PYTHONPATH=src python examples/federated_noniid_torch.py              # on the card
    PYTHONPATH=src python examples/federated_noniid_torch.py --device cpu

An in-process cluster (coordinator + client threads over the packed wire
codec) trains an MLP 64-64-10 at 95% gradient sparsity under federated
conditions:

* labels sharded non-IID across clients (Dirichlet alpha=0.3),
* 80% per-round partial participation,
* one straggler on a 100 KB/s uplink, one late joiner, one early leaver,
* int8-quantized upward values, secondary-compressed downloads,
* seeded frame drops and retries.

The up/down numbers are measured wire bytes (headers, scales and
bit-packed values included); the example checks that they are the served
rounds' static frame sizes.  The weights come from the port's MLP init
(seed 0), not the reference's ``jax.random`` draw, so the run is not held
to the reference bit for bit.
"""
import argparse
import dataclasses

from repro_torch import kernels
from repro_torch.cluster import run_inprocess, wire
from repro_torch.cluster.scenarios import NonIIDClassification, hetero_plans
from repro_torch.core import make_strategy
from repro_torch.core.paramspace import ParamSpace
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models.mlp import MLP

DENSITY = 0.05


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=30)
    args = ap.parse_args(argv)
    n_clients, n_rounds = args.clients, args.rounds

    task = ClassificationTask(n_features=64, n_classes=10, batch_size=32,
                              noise=0.8, seed=0, device=args.device)
    data = NonIIDClassification(task=task, alpha=0.3, n_clients=n_clients)
    model = MLP((64, 64, 10), start=1, scale=0.18, seed=0,
                device=args.device)
    params0 = model.params()

    plans = hetero_plans(n_clients, n_rounds, hetero=0.8, seed=1,
                         participation=0.8, late_join=1, early_leave=1)
    # client 0 is additionally stuck behind a 100 KB/s uplink
    plans[0] = dataclasses.replace(plans[0], bandwidth=100e3)

    kernels.reset_launches()
    final, hist = run_inprocess(
        make_strategy("dgs", density=DENSITY, momentum=0.7,
                      quantize="int8"),
        model.grad_fn, params0,
        lambda e, k: data.batch(int(e), int(k) % n_clients),
        plans=plans, lr=0.1, secondary_density=DENSITY,
        inject_faults=True)
    n = max(1, len(hist.losses))
    acc = model.accuracy(final, data.eval_set(1024))
    print(f"{n} federated rounds served "
          f"(partial participation thins {n_clients * n_rounds} slots)")
    print(f"loss {hist.losses[:5].mean():.3f} -> "
          f"{hist.losses[-5:].mean():.3f}  acc={acc:.3f}")
    print(f"measured wire: up={hist.up_bytes / 1e3:.1f}KB "
          f"({hist.up_bytes / n:.0f}B/round)  "
          f"down={hist.down_bytes / 1e3:.1f}KB "
          f"({hist.down_bytes / n:.0f}B/round)")
    print(f"mean staleness {hist.staleness.mean():.1f} events")
    # every served round moved one int8 UP frame and one DOWN frame of the
    # static sizes of the arena's k's
    space = ParamSpace.from_tree(params0)
    seg = space.ks(DENSITY)
    up = wire.frame_bytes_static(seg, space.total, "int8")
    down = wire.frame_bytes_static(seg, space.total, "none")
    print(f"frames: {len(hist.losses)} x ({up} B up, {down} B down) = "
          f"{len(hist.losses) * up} B up, {len(hist.losses) * down} B down")
    if (hist.up_bytes, hist.down_bytes) != \
            (len(hist.losses) * up, len(hist.losses) * down):
        raise AssertionError("the measured bytes are not the served "
                             "rounds' frames")
    launches = {info.name: info.launches for info in kernels.KERNELS}
    print(f"kernel launches: {launches}")
    return {"hist": hist, "final": final, "up_frame": up,
            "down_frame": down, "launches": launches}


if __name__ == "__main__":
    main()
