"""Launch a real multi-process federated cluster over TCP (PyTorch port of
``repro.launch.cluster``).

    PYTHONPATH=src python -m repro_torch.launch.cluster --clients 4 --rounds 20
    PYTHONPATH=src python -m repro_torch.launch.cluster --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.cluster --features 512 \
        --hidden 2048,2304,2048 --classes 10 --density 0.001 ...

The main process runs the coordinator; each client is a separate OS process
(``--role client`` re-invocations of this module) connecting over a real
socket, so every gradient crosses the packed wire codec and the printed
up/down numbers are *measured* bytes, not a formula.  All processes rebuild
the identical problem (an MLP on the gaussian-blobs task, optionally
Dirichlet non-IID sharded) from the shared ``--seed``, its weights made
with numpy; nothing but wire frames moves between them.  ``--hidden`` takes
one width or a comma-separated list of them (one hidden layer each).  Every process
computes on ``--device`` (default: the card).

``--smoke`` is the guard for the multiprocess path: 2 clients, a few
int8-quantized rounds; it asserts that every event arrived and the loss
dropped, and exits nonzero on any hang (every stage is timeout-bounded).

The reference's ``--shards``, ``--ports``, ``--pin-slot`` and
``--mesh-shards`` belong to the sharded coordinators, a later slice of the
port.
"""
from __future__ import annotations

import argparse
import atexit
import signal
import subprocess
import sys
import time

import numpy as np

from repro_torch import telemetry

log = telemetry.get_logger("cluster")

# every child this launcher spawns, so nothing is orphaned when the
# launcher dies mid-run (e.g. `timeout` sending SIGTERM to a hung smoke)
_CHILDREN: list[subprocess.Popen] = []


def spawn(cmd) -> subprocess.Popen:
    """``Popen`` tracked for reaping by :func:`reap_children`."""
    proc = subprocess.Popen(cmd)
    _CHILDREN.append(proc)
    return proc


def reap_children(timeout: float = 5.0):
    """Terminate -> wait -> kill every live tracked child."""
    live = [p for p in _CHILDREN if p.poll() is None]
    for p in live:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.monotonic() + timeout
    for p in live:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
    _CHILDREN.clear()


def wait_children(procs, timeout: float) -> list[int]:
    """Wait for each child (killing one that outlives ``timeout``), stop
    tracking it, and return the nonzero exit codes."""
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        finally:
            if p in _CHILDREN:
                _CHILDREN.remove(p)
    return [p.returncode for p in procs if p.returncode != 0]


def install_reaper():
    """Reap children on normal exit AND on SIGTERM/SIGINT, re-exiting with
    the conventional 128 + signum code."""
    atexit.register(reap_children)

    def _on_signal(signum, frame):
        reap_children()
        sys.exit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass   # not the main thread (embedded use): atexit still runs


def problem(args):
    """Deterministic shared problem, identical in every process: (params0,
    grad_fn, batch_fn, accuracy) on ``args.device``."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.models.mlp import MLP

    task = ClassificationTask(n_features=args.features,
                              n_classes=args.classes,
                              batch_size=args.batch_size,
                              noise=0.6, seed=args.seed, device=args.device)
    if args.alpha > 0:
        from repro_torch.cluster.scenarios import NonIIDClassification
        data = NonIIDClassification(task=task, alpha=args.alpha,
                                    shard_seed=args.seed,
                                    n_clients=args.clients)
    else:
        data = task

    rng = np.random.default_rng(args.seed)
    dims = (args.features, *args.hidden, args.classes)
    params_np = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]), start=1):
        # 0.2, or He's sqrt(2 / fan-in) where that is smaller (wide layers)
        scale = min(0.2, (2.0 / a) ** 0.5)
        params_np[f"w{i}"] = (rng.normal(size=(a, b)) * scale).astype(
            np.float32)
        params_np[f"b{i}"] = np.zeros(b, np.float32)
    params0 = params_from_numpy(params_np, args.device)
    model = MLP(dims, start=1, device=args.device)

    def batch_fn(e, k):
        return data.batch(int(e), int(k) % args.clients)

    def accuracy(p):
        return model.accuracy(p, task.eval_set(512))

    return params0, model.grad_fn, batch_fn, accuracy


def strategy(args):
    from repro_torch.core import make_strategy

    kw = {}
    if args.strategy != "asgd":
        kw["density"] = args.density
        kw["quantize"] = args.quantize
    if args.strategy in ("dgs", "dgc_async"):
        kw["momentum"] = args.momentum
    return make_strategy(args.strategy, **kw)


def secondary_spec(args):
    from repro_torch.core.engine import CompressionSpec

    return CompressionSpec(engine="exact", quantize=args.secondary_quantize)


def run_client(args):
    from repro_torch.cluster.client import ClusterClient
    from repro_torch.cluster.scenarios import ClientPlan
    from repro_torch.cluster.transport import TcpClientTransport

    params0, grad_fn, batch_fn, _ = problem(args)
    transport = TcpClientTransport(args.host, args.port, args.client_id,
                                   connect_timeout=args.timeout)
    try:
        ClusterClient(
            transport=transport,
            strategy=strategy(args),
            grad_fn=grad_fn,
            params0=params0,
            batch_fn=batch_fn,
            plan=ClientPlan(client_id=args.client_id, n_rounds=args.rounds,
                            participation=args.participation,
                            seed=args.seed),
            lr=args.lr,
            reply_timeout=args.timeout,
            max_retries=3,
        ).run()
    finally:
        transport.close()
    return 0


def run_coordinator(args, *, spawn_clients: bool):
    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.cluster.transport import TcpCoordinatorTransport

    params0, _, _, accuracy = problem(args)
    recorder = (telemetry.Recorder(args.trace_dir)
                if args.trace_dir else telemetry.NULL)
    if recorder.enabled:
        telemetry.set_recorder(recorder)
    transport = TcpCoordinatorTransport(args.host, args.port)
    log.info(f"[coordinator] listening on {transport.host}:{transport.port} "
             f"({args.clients} clients x {args.rounds} rounds, device "
             f"{args.device or 'cuda'})")
    procs = []
    if spawn_clients:
        for c in range(args.clients):
            procs.append(spawn(
                [sys.executable, "-m", "repro_torch.launch.cluster",
                 "--role", "client", "--client-id", str(c),
                 "--port", str(transport.port)] + _shared_flags(args)))
    coord = Coordinator(
        transport=transport,
        params0=params0,
        n_slots=args.clients,
        secondary_density=args.secondary_density,
        secondary_spec=secondary_spec(args),
        recv_timeout=args.timeout,
        recorder=recorder,
    )
    t0 = time.perf_counter()
    try:
        with recorder.span("cluster/serve"):
            final, hist = coord.serve()
        dt = time.perf_counter() - t0
    finally:
        # on any serve() failure, still reap the children + free the port
        failed = wait_children(procs, args.timeout)
        transport.close()

    n = max(1, len(hist.losses))
    log.info(f"[coordinator] {len(hist.losses)} events in {dt:.3f} s | "
             f"loss {hist.losses[:3].mean():.4f} -> "
             f"{hist.losses[-3:].mean():.4f} | acc {accuracy(final):.3f}")
    log.info(f"[coordinator] measured wire bytes: up={hist.up_bytes} "
             f"({hist.up_bytes / n:.0f}/event) down={hist.down_bytes} "
             f"({hist.down_bytes / n:.0f}/event)")
    if recorder.enabled:
        telemetry.set_recorder(None)
        paths = recorder.close()
        log.info(f"[coordinator] telemetry: {' '.join(paths)}")
    if args.smoke:
        problems = [
            (bool(failed), f"client exit codes {failed}"),
            (len(hist.losses) != args.clients * args.rounds,
             f"{len(hist.losses)} events, not {args.clients * args.rounds}"),
            (not hist.losses[-3:].mean() < hist.losses[:3].mean(),
             "the loss did not decrease"),
            (not (hist.up_bytes > 0 and hist.down_bytes > 0),
             "no wire bytes"),
        ]
        bad = [why for hit, why in problems if hit]
        if bad:
            raise SystemExit("smoke FAILED: " + "; ".join(bad))
        log.info("[coordinator] smoke OK")
    return 0


def _shared_flags(args) -> list[str]:
    flags = ["--clients", str(args.clients), "--rounds", str(args.rounds),
             "--strategy", args.strategy, "--density", str(args.density),
             "--momentum", str(args.momentum), "--quantize", args.quantize,
             "--lr", str(args.lr), "--seed", str(args.seed),
             "--features", str(args.features), "--classes", str(args.classes),
             "--hidden", ",".join(map(str, args.hidden)), "--batch-size",
             str(args.batch_size), "--alpha", str(args.alpha),
             "--participation", str(args.participation),
             "--host", args.host, "--timeout", str(args.timeout)]
    if args.device:
        flags += ["--device", args.device]
    if args.log_level:
        flags += ["--log-level", args.log_level]
    return flags


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags; ``--smoke`` overrides the problem's size."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--role", choices=("auto", "coordinator", "client"),
                   default="auto")
    p.add_argument("--smoke", action="store_true",
                   help="tiny timeout-guarded multi-process run")
    p.add_argument("--device", default=None,
                   help="torch device of every process (default: the card; "
                        "'cpu' to run without one)")
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--client-id", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--strategy", default="dgs")
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--momentum", type=float, default=0.7)
    p.add_argument("--quantize", default="none",
                   choices=("none", "bf16", "int8", "tern"))
    p.add_argument("--secondary-density", type=float, default=None)
    p.add_argument("--secondary-quantize", default="none",
                   choices=("none", "bf16", "int8", "tern"))
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.0,
                   help="Dirichlet non-IID concentration (0 = IID)")
    p.add_argument("--participation", type=float, default=1.0)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--hidden", default=(32,),
                   type=lambda s: tuple(int(w) for w in s.split(",")),
                   help="hidden widths, comma-separated")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--trace-dir", default=None,
                   help="write trace.json + events.jsonl (flight recorder) "
                        "under this directory -- coordinator role only")
    p.add_argument("--log-level", default=None,
                   help="debug | info | warning | error (default: the "
                        "REPRO_LOG environment variable, or info)")
    p.add_argument("--log-file", default=None,
                   help="mirror launcher output (timestamped) to a file")
    args = p.parse_args(argv)
    if args.smoke:
        args.clients, args.rounds = 2, 6
        args.strategy, args.density, args.quantize = "dgs", 0.1, "int8"
        args.secondary_density = 0.2
        args.lr = 0.1
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.log_level:
        telemetry.set_level(args.log_level)
    if args.log_file:
        telemetry.set_log_file(args.log_file)
    install_reaper()

    if args.role == "client":
        return run_client(args)
    return run_coordinator(args, spawn_clients=args.role == "auto")


if __name__ == "__main__":
    sys.exit(main())
