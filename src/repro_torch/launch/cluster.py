"""Launch a real multi-process federated cluster over TCP (PyTorch port of
``repro.launch.cluster``).

    PYTHONPATH=src python -m repro_torch.launch.cluster --clients 4 --rounds 20
    PYTHONPATH=src python -m repro_torch.launch.cluster --clients 4 --shards 2
    PYTHONPATH=src python -m repro_torch.launch.cluster --smoke --device cpu \
        [--shards 2 | --mesh-shards 2]
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

``--shards S`` range-partitions the parameter arena across S coordinator
shards, each listening on its own port; clients connect to every shard
(``--ports p0,p1,...``), split each upward frame by index range and merge
the per-shard downward diffs.  ``--mesh-shards S`` runs the same partition
as ONE coordinator hosting all S shard arenas on its device (the mesh
server); clients connect to one ordinary port.  The two are exclusive.
Sharded runs serve the clients in a LOCKSTEP round-robin schedule (the
clients claim their slot, ``--pin-slot``), so every shard sees the same
event order, and an S-shard run reproduces the 1-shard run's losses and
final parameters bit for bit (a mesh run its measured bytes too).

``--smoke`` is the guard for the multiprocess path: 2 clients, a few
int8-quantized rounds; it asserts that every event arrived and the loss
dropped, and exits nonzero on any hang (every stage is timeout-bounded).
With ``--shards S`` or ``--mesh-shards S`` it first serves a 1-shard
lockstep reference and then asserts the sharded run bit-identical to it
(for a mesh run, the bytes too).
"""
from __future__ import annotations

import argparse
import atexit
import signal
import subprocess
import sys
import threading
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


def _shard_spec(params0, n_shards: int):
    """The leaf-aligned partition every process derives from the same
    ``params0``, so the clients' splits and the shards' ownership agree."""
    from repro_torch.core.paramspace import ParamSpace, ShardSpec

    if n_shards <= 1:
        return None
    return ShardSpec.for_space(ParamSpace.from_tree(params0), n_shards)


def run_client(args):
    from repro_torch.cluster.client import ClusterClient
    from repro_torch.cluster.scenarios import ClientPlan
    from repro_torch.cluster.transport import TcpClientTransport

    params0, grad_fn, batch_fn, _ = problem(args)
    ports = ([int(x) for x in args.ports.split(",")] if args.ports
             else [args.port])
    transports = []
    try:
        for port in ports:
            transports.append(TcpClientTransport(
                args.host, port, args.client_id,
                connect_timeout=args.timeout))
        ClusterClient(
            transport=transports if len(transports) > 1 else transports[0],
            shard_spec=_shard_spec(params0, len(ports)),
            pin_slot=args.pin_slot,
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
        for t in transports:
            t.close()
    return 0


def serve_cluster(args, params0, *, spawn_clients: bool, n_shards: int = 1,
                  mesh_shards: int = 0, recorder=telemetry.NULL,
                  lockstep: bool | None = None):
    """One coordinator-side run over TCP: ``n_shards`` shard coordinators
    (shards 1..S-1 on threads), or one mesh coordinator of ``mesh_shards``
    shards, with ``args.clients`` client processes when ``spawn_clients``.
    Returns ``(final, History, seconds)``, a sharded run's shards joined.

    ``lockstep`` serves the clients in an explicit round-robin schedule
    (client 0..C-1, ``rounds`` times) instead of arrival order, the
    determinism sharded runs need so that every shard sees one event order
    (and the 1-shard reference a sharded smoke is held to sees it too);
    it defaults to a sharded run.  Lockstep clients claim their slot
    (``--pin-slot``).
    """
    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.cluster.runner import join_shards
    from repro_torch.cluster.transport import (ScheduleDriven,
                                               TcpCoordinatorTransport)

    if lockstep is None:
        lockstep = n_shards > 1 or mesh_shards > 0
    transports = [TcpCoordinatorTransport(args.host,
                                          args.port if s == 0 else 0)
                  for s in range(n_shards)]
    ports = [t.port for t in transports]
    log.info(f"[coordinator] listening on {transports[0].host}:"
             f"{','.join(map(str, ports))} ({args.clients} clients x "
             f"{args.rounds} rounds, {n_shards} shard(s), mesh shards "
             f"{mesh_shards}, device {args.device or 'cuda'})")
    procs = []
    if spawn_clients:
        for c in range(args.clients):
            cmd = [sys.executable, "-m", "repro_torch.launch.cluster",
                   "--role", "client", "--client-id", str(c),
                   "--ports", ",".join(map(str, ports))] + _shared_flags(args)
            if lockstep:
                cmd.append("--pin-slot")
            procs.append(spawn(cmd))
    shard_spec = _shard_spec(params0, n_shards)
    order = np.tile(np.arange(args.clients), args.rounds)
    coords = [Coordinator(
        transport=transports[s],
        params0=params0,
        n_slots=args.clients,
        secondary_density=args.secondary_density,
        secondary_spec=secondary_spec(args),
        scheduler=ScheduleDriven(order) if lockstep else None,
        recv_timeout=args.timeout,
        recorder=recorder,
        shard_spec=shard_spec,
        shard_id=s,
        mesh_shards=mesh_shards,
    ) for s in range(n_shards)]
    results: list = [None] * n_shards
    errors: list = []

    def _serve(s):
        try:
            results[s] = coords[s].serve()
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=_serve, args=(s,), daemon=True)
               for s in range(1, n_shards)]
    t0 = time.perf_counter()
    try:
        with recorder.span("cluster/serve"):
            for t in threads:
                t.start()
            results[0] = coords[0].serve()
            for t in threads:
                t.join(timeout=args.timeout)
        dt = time.perf_counter() - t0
    finally:
        # on any serve() failure, still reap the children + free the ports
        failed = wait_children(procs, args.timeout)
        for t in transports:
            t.close()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a shard coordinator outlived the "
                           f"{args.timeout} s join")
    if failed:
        raise RuntimeError(f"client exit codes {failed}")
    final, hist = join_shards(params0, results)
    return final, hist, dt


def run_coordinator(args, *, spawn_clients: bool):
    import torch

    params0, _, _, accuracy = problem(args)
    recorder = (telemetry.Recorder(args.trace_dir)
                if args.trace_dir else telemetry.NULL)
    if recorder.enabled:
        telemetry.set_recorder(recorder)
    ref = None
    if args.smoke and (args.shards > 1 or args.mesh_shards > 0):
        # the bit-parity reference: the same problem, the same lockstep
        # order, ONE unsharded server; the sharded run must reproduce it
        ref = serve_cluster(args, params0, spawn_clients=spawn_clients,
                            lockstep=True)
    final, hist, dt = serve_cluster(
        args, params0, spawn_clients=spawn_clients, n_shards=args.shards,
        mesh_shards=args.mesh_shards, recorder=recorder)

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
            (len(hist.losses) != args.clients * args.rounds,
             f"{len(hist.losses)} events, not {args.clients * args.rounds}"),
            (not hist.losses[-3:].mean() < hist.losses[:3].mean(),
             "the loss did not decrease"),
            (not (hist.up_bytes > 0 and hist.down_bytes > 0),
             "no wire bytes"),
        ]
        if ref is not None:
            ref_final, ref_hist, _ = ref
            problems += [
                (not np.array_equal(hist.losses, ref_hist.losses),
                 "sharded losses diverged from the 1-shard reference"),
                (not all(torch.equal(final[key], ref_final[key])
                         for key in ref_final),
                 "sharded params diverged from the 1-shard reference"),
                (args.mesh_shards > 0 and (hist.up_bytes, hist.down_bytes)
                 != (ref_hist.up_bytes, ref_hist.down_bytes),
                 "mesh-sharded bytes diverged from the 1-shard reference"),
            ]
        bad = [why for hit, why in problems if hit]
        if bad:
            raise SystemExit("smoke FAILED: " + "; ".join(bad))
        if ref is None:
            log.info("[coordinator] smoke OK")
        else:
            label = (f"{args.mesh_shards}-mesh-shard" if args.mesh_shards
                     else f"{args.shards}-shard")
            log.info(f"[coordinator] smoke OK: {label} run bit-identical "
                     f"to the 1-shard reference")
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
    p.add_argument("--shards", type=int, default=1,
                   help="coordinator shards: range-partition the parameter "
                        "arena across S servers, one port each (lockstep "
                        "round-robin serving; bit-identical to --shards 1)")
    p.add_argument("--mesh-shards", type=int, default=0,
                   help="mesh shards: ONE coordinator hosts all S shard "
                        "arenas on its device; one port, clients unchanged, "
                        "bytes AND losses bit-identical to the unsharded "
                        "run (exclusive with --shards)")
    p.add_argument("--ports", default=None,
                   help="client role: comma-separated coordinator shard "
                        "ports, shard order (overrides --port)")
    p.add_argument("--pin-slot", action="store_true",
                   help="client role: claim worker slot == client id "
                        "(lockstep runs need every shard to agree)")
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
    if args.mesh_shards and args.shards > 1:
        p.error("--shards and --mesh-shards are two different sharding "
                "runtimes (S coordinator shards vs one mesh server): pass "
                "exactly one of them")
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
