"""Training launcher (PyTorch port of ``repro.launch.train``): the reduced
variant of an architecture trained data-parallel with DGS as the gradient
exchange, printing losses.  Every family runs (dense GQA, MLA, MoE,
Mamba2, the hybrid, and the modality ones with seeded frontend
embeddings):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --devices 4 --steps 3 --batch 4 --seq 32 --arch mamba2-780m

``--devices N`` is the number of mesh cells, as the reference's: an even
N above 1 is a ``(N/2 data, 2 model)`` mesh, else ``(N, 1)``; the cells
are lanes of one process on ``--device`` (None = the card).  Under
``torchrun`` (``WORLD_SIZE`` set) it runs one cell per process instead,
over ``torch.distributed``, ``--model-par`` (default: the same rule on
``WORLD_SIZE``) shards each data worker:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --steps 3 --batch 4 --seq 32

With a card for every rank of a host the ranks talk over NCCL
(``mesh.init_process_mesh``); that leg has not yet run on several cards.

``--trace-dir DIR`` records the train step's spans (``TrainStep``'s and
the exchange's) and writes ``DIR/trace.json`` (Chrome trace events) and
``DIR/events.jsonl``, whose ``span_totals`` record holds per span name
its count over the run and its host, self and device milliseconds a step
(device ms on a card only: CUDA events at the spans' ends).
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--mode", default="allgather",
                    choices=["dense", "allgather", "shardedps"])
    ap.add_argument("--density", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "exact", "sampled", "blockwise"],
                    help="top-k compression engine (core/engine.py)")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "bf16", "int8", "tern"],
                    help="wire quantization of sparse message values")
    ap.add_argument("--sampled-above", type=int, default=1 << 20,
                    help="auto engine: sampled threshold for leaves/rows "
                         "with at least this many elements")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="accepted for the reference's command line; the "
                         "launcher always trains the reduced variant")
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh cells, as lanes of this process: (N/2, 2) "
                         "when N is even and above 1, else (N, 1) (ignored "
                         "under torchrun: one cell per process)")
    ap.add_argument("--model-par", type=int, default=None,
                    help="under torchrun: model shards per data worker "
                         "(default: 2 when WORLD_SIZE is even and above 1)")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-level", default=None,
                    help="silence/route launcher output: debug | info | "
                         "warning | error (default: REPRO_LOG env or info)")
    ap.add_argument("--log-file", default=None,
                    help="mirror launcher output (timestamped) to a file")
    ap.add_argument("--trace-dir", default=None,
                    help="write the train step's spans (trace.json) and "
                         "their totals a step (events.jsonl) under this "
                         "directory -- rank 0 only under torchrun")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from repro_torch import telemetry
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.data.synthetic import TokenStream, seeded_generator
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_train_step, whole_params
    from repro_torch.launch.sharding import param_specs, shard_params
    from repro_torch.models.model import abstract_params, init_params

    log = telemetry.get_logger("train")
    if args.log_level:
        telemetry.set_level(args.log_level)
    if args.log_file:
        telemetry.set_log_file(args.log_file)

    cfg = get_arch(args.arch).reduced()
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        model_par = args.model_par or _model_par(world)
        mesh = mesh_lib.init_process_mesh(
            int(os.environ["RANK"]), world, "env://", device,
            model=model_par)
        device = mesh.device
        if int(os.environ["RANK"]) != 0:
            telemetry.set_level("warning")
    else:
        model_par = _model_par(args.devices)
        mesh = mesh_lib.LaneMesh(args.devices // model_par, device,
                                 model=model_par)
    log.info(f"[train] arch={cfg.name} mesh={mesh.shape} "
             f"mode={args.mode} density={args.density} engine={args.engine} "
             f"quantize={args.quantize}")

    ex_cfg = ExchangeConfig(mode=args.mode, density=args.density,
                            momentum=args.momentum, engine=args.engine,
                            quantize=args.quantize,
                            sampled_threshold_above=args.sampled_above)
    step = build_train_step(cfg, mesh, ex_cfg, lr=args.lr, remat=False)
    if args.trace_dir and int(os.environ.get("RANK", 0)) == 0:
        step.recorder = telemetry.Recorder(args.trace_dir,
                                           device=device.type == "cuda")
    params = init_params(cfg, seed=0, device=device)
    if not mesh.model.lanes:
        # a rank keeps its model shard of every leaf
        params = shard_params(params, param_specs(cfg, abstract_params(cfg),
                                                  model_par),
                              mesh.model.rank, model_par)
    ex_state = step.init_state(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=0, device=device)

    def batch(i):
        """Step ``i``'s global batch; the modality families' frontend
        embeddings come from ``seeded_generator(1, i)`` (every rank draws
        the same)."""
        out = stream.batch(i)
        if cfg.frontend_tokens:
            out["frontend_embeds"] = torch.randn(
                (args.batch, cfg.frontend_tokens, cfg.d_model),
                generator=seeded_generator(1, i)).to(device, cfg.cdtype)
        return out

    try:
        for i in range(args.steps):
            params, ex_state, loss = step(params, ex_state, batch(i))
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                log.info(f"  step {i:4d} loss={float(loss):.4f}")
        if args.checkpoint:
            params = whole_params(params, cfg, mesh)
            if int(os.environ.get("RANK", 0)) == 0:
                save_checkpoint(args.checkpoint, params, step=args.steps)
                log.info(f"[train] saved {args.checkpoint}")
        if step.recorder.enabled:
            _write_span_totals(step.recorder, args.steps, device)
    finally:
        if "WORLD_SIZE" in os.environ:
            import torch.distributed as dist
            mesh.close()
            dist.destroy_process_group()
    log.info("[train] done")


def _write_span_totals(recorder, steps: int, device) -> None:
    """Per span name its count over the run and its host, self and device
    ms a step (device ms None off the card), as one ``span_totals``
    record, then the recorder's files."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans = {}
    for name, tot in recorder.totals().items():
        dev_s = tot["device_s"]
        spans[name] = {"count": tot["count"],
                       "host_ms": 1e3 * tot["host_s"] / steps,
                       "self_ms": 1e3 * tot["self_s"] / steps,
                       "device_ms": (None if dev_s is None
                                     else 1e3 * dev_s / steps)}
    recorder.event("span_totals", steps=steps, spans=spans)
    recorder.close()


def _model_par(n: int) -> int:
    """The reference's rule: two model shards when ``n`` is even and
    above 1."""
    return 2 if n % 2 == 0 and n > 1 else 1


if __name__ == "__main__":
    main()
