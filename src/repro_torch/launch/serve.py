"""Serving launcher: a live inference fleet fed by sparse model diffs
(PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --features 512 \\
        --hidden 2048,2304,2048 --classes 10 --push-density 0.001 ...

Roles:

* ``--role fleet`` (default) -- the serve leg end to end over TCP: this
  process runs the training coordinator with the subscriber leg on;
  training clients (``repro_torch.launch.cluster --role client``) and
  inference replicas (``--role replica``) are separate OS processes.
  Replicas SUBscribe, apply one coalesced re-sparsified ARENA diff per
  decode boundary (bounded staleness) and SYNC to the bit-exact final
  model at quiesce.  With ``--ckpt-dir`` the coordinator appends sparse
  delta checkpoints of the live arena.  ``--smoke`` (1 client, 12 rounds,
  2 replicas, a checkpoint directory under ``--out-dir``) asserts that
  every replica's final arena equals the server model bit for bit and
  that the restored checkpoint chain does too.
* ``--role replica`` -- one inference replica process: connects over TCP,
  decodes (the MLP's accuracy on a fixed eval set) between diff pulls and
  writes its final arena to ``--out`` (``.npy``).
* ``--role decode`` -- the standalone decode demo: the reduced variant of
  ``--arch`` (any of the zoo: dense GQA, MLA, MoE, Mamba2, the hybrid, or
  a modality architecture, whose seeded frontend embeddings take the
  prompt's first positions) prefills a
  seeded prompt of ``--batch`` x ``--prompt-len`` tokens, then decodes
  ``--gen - 1`` tokens against its KV, latent or SSM caches, greedy
  or sampled at ``--temperature``, and prints the generated ids.  No
  cluster.  It prints the reference's ``(1, --devices)`` mesh and, as the
  reference's plain-jit prefill and decode do under it, computes
  unsharded; the sharded serving path is ``launch.steps``'
  ``build_prefill_step`` and ``build_serve_step``.

      PYTHONPATH=src python -m repro_torch.launch.serve --role decode \
          --device cpu

The fleet and its replicas rebuild the same problem from ``--seed``
(``launch.cluster.problem``).  Every role computes on ``--device``
(default: the card).
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

import numpy as np

from repro_torch import telemetry

from . import cluster as cluster_launch

log = telemetry.get_logger("serve")


# ---------------------------------------------------------------------------
# --role replica: one TCP inference replica process
# ---------------------------------------------------------------------------

def run_replica(args) -> int:
    from repro_torch.cluster import wire
    from repro_torch.cluster.replica import InferenceReplica
    from repro_torch.cluster.transport import TcpClientTransport
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.models.mlp import MLP

    params0, _, _, _ = cluster_launch.problem(args)
    # the decode workload: the classification forward on a fixed eval set,
    # enough to decode while training runs; the arena swapped underneath it
    # is what the fleet demonstrates
    task = ClassificationTask(n_features=args.features,
                              n_classes=args.classes,
                              batch_size=args.batch_size, noise=0.6,
                              seed=args.seed, device=args.device)
    eval_set = task.eval_set(256)
    model = MLP((args.features, *args.hidden, args.classes), start=1,
                device=args.device)
    accs = []

    def decode_fn(params, step):
        accs.append(model.accuracy(params, eval_set))

    transport = TcpClientTransport(args.host, args.port,
                                   wire.SUBSCRIBER_BASE + args.replica_id,
                                   connect_timeout=args.timeout)
    try:
        result = InferenceReplica(
            transport, params0, replica_id=args.replica_id,
            max_staleness=args.max_staleness, decode_fn=decode_fn,
            recv_timeout=args.timeout).run()
    finally:
        transport.close()
    if args.out:
        np.save(args.out, result.arena.cpu().numpy())
    s = result.stats
    log.info(f"[replica {args.replica_id}] version={result.version} "
             f"decodes={s['decodes']} diffs={s['diffs']} "
             f"pulls={s['pulls']} bytes_in={s['bytes_in']} "
             f"stale_waits={s['stale_waits']} "
             f"acc {accs[0] if accs else 0:.3f} -> "
             f"{accs[-1] if accs else 0:.3f}")
    return 0


# ---------------------------------------------------------------------------
# --role fleet: coordinator + training clients + replica fleet over TCP
# ---------------------------------------------------------------------------

def run_fleet(args) -> int:
    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.cluster.transport import TcpCoordinatorTransport
    from repro_torch.core.paramspace import ParamSpace

    params0, _, _, accuracy = cluster_launch.problem(args)
    recorder = (telemetry.Recorder(args.trace_dir)
                if args.trace_dir else telemetry.NULL)
    if recorder.enabled:
        telemetry.set_recorder(recorder)

    transport = TcpCoordinatorTransport(args.host, args.port)
    out_dir = pathlib.Path(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    log.info(f"[fleet] coordinator on {transport.host}:{transport.port} "
             f"({args.clients} trainer(s) x {args.rounds} rounds, "
             f"{args.replicas} replica(s), device {args.device or 'cuda'})")

    shared = cluster_launch._shared_flags(args)
    procs = [cluster_launch.spawn(
        [sys.executable, "-m", "repro_torch.launch.cluster",
         "--role", "client", "--client-id", str(c),
         "--port", str(transport.port)] + shared)
        for c in range(args.clients)]
    replica_outs = [out_dir / f"replica_{i}.npy"
                    for i in range(args.replicas)]
    procs += [cluster_launch.spawn(
        [sys.executable, "-m", "repro_torch.launch.serve",
         "--role", "replica", "--replica-id", str(i),
         "--port", str(transport.port), "--out", str(replica_outs[i]),
         "--max-staleness", str(args.max_staleness)] + shared)
        for i in range(args.replicas)]

    coord = Coordinator(
        transport=transport,
        params0=params0,
        n_slots=args.clients,
        secondary_density=args.secondary_density,
        secondary_spec=cluster_launch.secondary_spec(args),
        recv_timeout=args.timeout,
        recorder=recorder,
        push_density=args.push_density,
        min_subscribers=args.replicas,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    t0 = time.perf_counter()
    try:
        with recorder.span("fleet/serve"):
            final, hist = coord.serve()
        dt = time.perf_counter() - t0
    finally:
        # on any serve() failure too: reap the children, free the port
        failed = cluster_launch.wait_children(procs, args.timeout)
        transport.close()

    cnt = hist.metrics["counters"]
    log.info(f"[fleet] {len(hist.losses)} events in {dt:.3f} s | "
             f"loss {hist.losses[:3].mean():.4f} -> "
             f"{hist.losses[-3:].mean():.4f} | acc {accuracy(final):.3f}")
    for i in range(args.replicas):
        log.info(f"[fleet] replica {i}: pushes="
                 f"{cnt.get(f'sub/{i}/pushes', 0):.0f} "
                 f"push_bytes={cnt.get(f'sub/{i}/push_bytes', 0):.0f} "
                 f"lag_max={cnt.get(f'sub/{i}/lag_max', 0):.0f} "
                 f"version={cnt.get(f'sub/{i}/version', 0):.0f}")
    if args.ckpt_dir:
        log.info(f"[fleet] delta checkpoint: "
                 f"{cnt.get('ckpt_deltas', 0):.0f} deltas, "
                 f"{cnt.get('ckpt_bytes', 0):.0f} bytes -> {args.ckpt_dir}")
    if recorder.enabled:
        telemetry.set_recorder(None)
        paths = recorder.close()
        log.info(f"[fleet] telemetry: {' '.join(paths)}")

    if args.smoke:
        from repro_torch.checkpoint import load_delta_checkpoint

        final_arena = ParamSpace.from_tree(params0).pack(final).cpu().numpy()
        problems = [
            (bool(failed), f"child exit codes {failed}"),
            (len(hist.losses) != args.clients * args.rounds,
             f"{len(hist.losses)} events, not {args.clients * args.rounds}"),
        ]
        problems += [
            (not (path.exists() and np.array_equal(np.load(path),
                                                   final_arena)),
             f"replica {i}'s final arena != the server model (bitwise)")
            for i, path in enumerate(replica_outs)]
        arena, version, _ = load_delta_checkpoint(args.ckpt_dir,
                                                  device=args.device)
        problems += [
            (not np.array_equal(arena.cpu().numpy(), final_arena),
             "the delta-checkpoint restore != the live arena (bitwise)"),
            (version != len(hist.losses),
             f"checkpoint version {version}, not {len(hist.losses)}")]
        bad = [why for hit, why in problems if hit]
        if bad:
            raise SystemExit("smoke FAILED: " + "; ".join(bad))
        log.info(f"[fleet] smoke OK: {args.replicas} replicas bit-identical "
                 f"to the server, checkpoint restore bit-identical")
    return 0


# ---------------------------------------------------------------------------
# --role decode: the standalone decode demo
# ---------------------------------------------------------------------------

def run_decode(args) -> int:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_arch(args.arch).reduced()
    device = resolve_device(args.device)
    mesh = {"data": 1, "model": args.devices}
    print(f"[serve] arch={cfg.name} mesh={mesh} device={device}")
    params = init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    max_len = args.prompt_len + args.gen
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    fe = None
    if cfg.frontend_tokens:
        fe = torch.randn((args.batch, cfg.frontend_tokens, cfg.d_model),
                         generator=gen, device=device).to(cfg.cdtype)

    def pick(logits):
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    logits, caches, _ = prefill(params, prompt, cfg, frontend_embeds=fe,
                                max_len=max_len)
    tokens = [pick(logits[:, -1])]
    for t in range(args.gen - 1):
        logits, caches = decode_step(params, caches, tokens[-1][:, None],
                                     args.prompt_len + t, cfg)
        tokens.append(pick(logits[:, 0]))
    out = torch.stack(tokens, dim=1).cpu()
    print("[serve] generated token ids:")
    for b in range(args.batch):
        print("  seq", b, out[b].tolist())
    print("[serve] done")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--role", choices=("fleet", "replica", "decode"),
                   default="fleet")
    p.add_argument("--smoke", action="store_true",
                   help="tiny fleet run + bit-identity asserts (replicas "
                        "against the server, checkpoint restore against "
                        "the live arena)")
    p.add_argument("--device", default=None,
                   help="torch device of every process (default: the card; "
                        "'cpu' to run without one)")
    # fleet / replica: the cluster problem's flags (launch.cluster's)
    p.add_argument("--clients", type=int, default=1)
    p.add_argument("--rounds", type=int, default=16)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--replica-id", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--strategy", default="dgs")
    p.add_argument("--density", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.7)
    p.add_argument("--quantize", default="none",
                   choices=("none", "bf16", "int8", "tern"))
    p.add_argument("--secondary-density", type=float, default=0.2)
    p.add_argument("--secondary-quantize", default="none",
                   choices=("none", "bf16", "int8", "tern"))
    p.add_argument("--push-density", type=float, default=0.25,
                   help="per-tensor top-k density of each replica push "
                        "(<= 0: ship the exact nonzero residual)")
    p.add_argument("--max-staleness", type=int, default=4,
                   help="decode boundaries an unanswered PULL may span "
                        "before the replica blocks for the diff")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--participation", type=float, default=1.0)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--hidden", default=(32,),
                   type=lambda s: tuple(int(w) for w in s.split(",")),
                   help="hidden widths, comma-separated")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--out", default=None,
                   help="replica role: write the final arena here (.npy)")
    p.add_argument("--out-dir", default=".serve_fleet",
                   help="fleet role: the replicas' final-arena directory")
    p.add_argument("--ckpt-dir", default=None,
                   help="append sparse delta checkpoints of the live arena "
                        "under this directory (--smoke: <out-dir>/ckpt)")
    p.add_argument("--ckpt-every", type=int, default=4)
    p.add_argument("--trace-dir", default=None,
                   help="write trace.json + events.jsonl (flight recorder)")
    p.add_argument("--log-level", default=None)
    p.add_argument("--log-file", default=None)
    # decode role
    p.add_argument("--arch", default="chatglm3-6b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--devices", type=int, default=4,
                   help="decode role: the model axis of the printed (1, N) "
                        "mesh; as the reference's plain-jit steps under it, "
                        "the demo computes unsharded (the sharded serving "
                        "path is launch.steps.build_serve_step)")
    p.add_argument("--temperature", type=float, default=0.0)
    args = p.parse_args(argv)
    if args.log_level:
        telemetry.set_level(args.log_level)
    if args.log_file:
        telemetry.set_log_file(args.log_file)
    if args.push_density is not None and args.push_density <= 0:
        args.push_density = None

    if args.smoke:
        args.clients, args.rounds, args.replicas = 1, 12, 2
        args.strategy, args.density = "dgs", 0.1
        args.secondary_density = 0.2
        if args.ckpt_dir is None:
            args.ckpt_dir = str(pathlib.Path(args.out_dir) / "ckpt")

    if args.role == "replica":
        return run_replica(args)
    if args.role == "decode":
        return run_decode(args)
    cluster_launch.install_reaper()
    return run_fleet(args)


if __name__ == "__main__":
    sys.exit(main())
