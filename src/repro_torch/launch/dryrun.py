"""Dry run of every (arch x shape) on the reference's production meshes,
with no card and no kernel: one device's resident bytes and the roofline
terms of its step (the port's counterpart of ``repro.launch.dryrun``,
which lowers and compiles each step with XLA).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun

For each combination one device of the mesh (data worker 0, model shard
0 of 16) is built on the meta device: its shards of the parameters
(``sharding.param_specs`` at the mesh's model size), the velocity and the
shardedps M and v (``distributed.init_state`` of a rank), its rows of the
batch (``batch_specs``) and, to decode, its caches (split over the data
axes as ``cache_specs`` splits them: the batch when it divides, else the
length, an SSM state whole; each model shard's own heads, as
``tensor_parallel.init_caches`` holds them).  Then
its step runs once on the meta device under ``FlopCounterMode``, the
model axis's collectives counted (``roofline.MetaAxis``); the exchange is
reckoned from its static cut (``roofline.wire_bytes``), not run.  One
JSON a combination.

``argument_bytes`` and ``output_bytes`` are the step's inputs and outputs
on one device; ``temp_bytes`` is the reference's XLA buffer-assignment
figure, which has no torch counterpart, and stays None.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.configs.shapes import InputShape, input_specs
from repro_torch.core.distributed import ExchangeConfig, init_state
from repro_torch.core.paramspace import (tree_flatten, tree_leaves,
                                         tree_unflatten)
from repro_torch.launch import roofline, sharding
from repro_torch.launch.mesh import MeshShape, production_mesh_shape
from repro_torch.models import model as model_lib


def _nbytes(tree) -> int:
    """The bytes of a tree of dicts, lists and (named) tuples of tensors:
    a parameter tree, a shard's caches, the shards' list of them."""
    if isinstance(tree, dict):
        return sum(_nbytes(val) for val in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(val) for val in tree)
    return tree.numel() * tree.element_size()


def _meta_inputs(specs: dict) -> dict:
    """Meta tensors of ``input_specs``' ``(shape, dtype)`` pairs."""
    return {key: torch.empty(shape, dtype=dtype, device="meta")
            for key, (shape, dtype) in specs.items()}


def _data_rows(n: int, n_data: int) -> int:
    """A device's share of ``n`` rows split over the data axes (all of
    them where they do not split, as ``cache_specs`` leaves them)."""
    return n // n_data if n % n_data == 0 and n >= n_data else n


def reckon(cfg, shape: InputShape, mesh: MeshShape,
           ex_cfg: ExchangeConfig, *, remat: bool = True) -> dict:
    """One device's resident bytes by part, its step's FLOPs, the model
    axis's collective counts and bytes, and the exchange's wire bytes (a
    train step's) on ``mesh``; nothing touches a device."""
    M, W = mesh.model_size, mesh.size
    whole = model_lib.abstract_params(cfg)
    specs = sharding.param_specs(cfg, whole, M)
    hints = sharding.shard_axis_hints(cfg, whole, M)
    axis = roofline.MetaAxis(M)
    params = sharding.shard_params(whole, specs, 0, M)
    local = [params] if M > 1 else params
    tp = axis if M > 1 else None
    parts = {"params": _nbytes(params)}
    out = {}
    b = _data_rows(shape.global_batch, W)
    if shape.kind == "train":
        state = init_state(params, ex_cfg, W, lanes=1, shard_axes=hints,
                           model=axis)
        parts["velocity"] = _nbytes(state.velocity)
        parts["exchange_state"] = _nbytes(state.m_shard) \
            + _nbytes(state.v_shard)
        batch = _meta_inputs(input_specs(cfg, dataclasses.replace(
            shape, global_batch=b)))
        parts["batch"] = _nbytes(batch)

        def step():
            leaves, paths = tree_flatten(params)
            live = [x.detach().requires_grad_() for x in leaves]
            p = tree_unflatten(paths, live)
            loss = model_lib.loss_fn([p] if M > 1 else p, batch, cfg,
                                     remat=remat, tp=tp)[0]
            torch.autograd.grad(loss, live)

        flops = roofline.count_flops(step)
        out["output_bytes"] = parts["params"] + parts["velocity"] \
            + parts["exchange_state"] + 4
        wire = roofline.wire_bytes(
            ex_cfg, W, [x.shape for x in tree_leaves(whole)], hints, M)
        # each resident tensor read once, every updated one written once
        nbytes = 2 * (parts["params"] + parts["velocity"]
                      + parts["exchange_state"]) + parts["batch"]
    elif shape.kind == "prefill":
        batch = _meta_inputs(input_specs(cfg, dataclasses.replace(
            shape, global_batch=b)))
        parts["batch"] = _nbytes(batch)
        res = {}

        def step():
            logits, caches, _ = model_lib.prefill(
                local, batch["tokens"], cfg,
                frontend_embeds=batch.get("frontend_embeds"), tp=tp)
            res["out"] = _nbytes(logits) + _nbytes(caches)

        flops = roofline.count_flops(step)
        out["output_bytes"] = res["out"]
        wire = 0
        nbytes = parts["params"] + parts["batch"] + res["out"]
    else:
        # cache_specs' rule: the batch over the data axes where it
        # splits, else the length
        L = shape.seq_len if b < shape.global_batch \
            else _data_rows(shape.seq_len, W)
        caches = model_lib.init_caches(cfg, b, L, long_mode=shape.long,
                                       device="meta", tp=tp)
        parts["caches"] = _nbytes(caches)
        token = torch.empty((b, 1), dtype=torch.int32, device="meta")
        parts["batch"] = _nbytes(token) + 4
        pos = min(shape.seq_len // 2, L - 1)
        res = {}

        def step():
            logits, _ = model_lib.decode_step(local, caches, token, pos,
                                              cfg, long_mode=shape.long,
                                              tp=tp)
            res["out"] = _nbytes(logits)

        flops = roofline.count_flops(step)
        out["output_bytes"] = res["out"] + parts["caches"]
        wire = 0
        # the cache writes (a slot a step) are left out: a lower bound
        nbytes = parts["params"] + parts["caches"] + res["out"]
    out.update(parts=parts, argument_bytes=sum(parts.values()),
               flops=float(flops), bytes=float(nbytes),
               wire=float(wire + axis.wire_bytes),
               model_axis_wire=axis.wire_bytes,
               collective_counts=dict(axis.counts))
    return out


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            ex_mode: str = "allgather", density: float = 0.01,
            out_dir: str | None = None, verbose: bool = True,
            wire_dtype: str = "float32",
            bucket_factor: float = 2.0) -> dict:
    """One (arch, shape, mesh) of the production meshes: its row, as the
    reference's dryrun writes it (``temp_bytes`` None)."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    mesh = production_mesh_shape(multi_pod=mesh_kind == "multi")
    ex_cfg = ExchangeConfig(mode=ex_mode, density=density,
                            wire_dtype=wire_dtype,
                            bucket_factor=bucket_factor)
    t0 = time.time()
    r = reckon(cfg, shape, mesh, ex_cfg)
    t_reckon = time.time() - t0
    report = roofline.report(
        arch=arch, shape=shape, mesh_name=mesh_kind, cfg=cfg,
        n_devices=mesh.n_devices, flops=r["flops"], nbytes=r["bytes"],
        wire=r["wire"], collective_counts=r["collective_counts"])
    row = report.row()
    row.update({
        "ex_mode": ex_mode if shape.kind == "train" else None,
        "reckon_s": round(t_reckon, 1),
        "argument_bytes": r["argument_bytes"],
        "argument_parts": r["parts"],
        "temp_bytes": None,
        "temp_bytes_note": "XLA's buffer assignment; no torch counterpart, "
                           "not reckoned",
        "output_bytes": r["output_bytes"],
        "model_axis_wire_bytes": r["model_axis_wire"],
        "bytes_note": "a lower bound reckoned from the shards (each "
                      "resident tensor read once, each written leaf "
                      "written once), not a measured traffic",
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} "
              f"({ex_mode if shape.kind == 'train' else shape.kind}): "
              f"OK  reckoned in {t_reckon:.1f}s")
        print(f"  resident: args={_gb(row['argument_bytes'])} "
              f"out={_gb(row['output_bytes'])} (per device; temp not "
              f"reckoned) {r['parts']}")
        print(f"  flops/dev={row['hlo_flops_per_device']:.3e} "
              f"bytes/dev={row['hlo_bytes_per_device']:.3e} (lower bound) "
              f"wire/dev={row['wire_bytes_per_device']:.3e}")
        print(f"  roofline (H100 SXM peaks): compute="
              f"{row['compute_s'] * 1e3:.2f}ms memory="
              f"{row['memory_s'] * 1e3:.2f}ms collective="
              f"{row['collective_s'] * 1e3:.2f}ms -> "
              f"dominant={row['dominant']}")
        print(f"  model-axis collectives: {row['collective_counts']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{mesh_kind}"
        if ex_mode != "allgather" and shape.kind == "train":
            tag += f"_{ex_mode}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(row, f, indent=1, default=str)
    return row


def _gb(x):
    return f"{x / 2**30:.2f}GiB" if x is not None else "?"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--ex-mode", default="allgather",
                    choices=["dense", "allgather", "shardedps"])
    ap.add_argument("--density", type=float, default=0.01)
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--bucket-factor", type=float, default=2.0)
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = sorted(SHAPES) if args.all or args.shape is None \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                try:
                    run_one(arch, shape, mesh_kind, ex_mode=args.ex_mode,
                            density=args.density, out_dir=args.out,
                            wire_dtype=args.wire_dtype,
                            bucket_factor=args.bucket_factor)
                except Exception as e:  # noqa: BLE001 -- report, go on
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    print(f"[dryrun] {arch} x {shape} x {mesh_kind}: "
                          f"FAIL {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
