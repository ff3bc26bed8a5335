"""One run of one cell: the program's train step built from the cell's
files, its first three steps checked against the plain reference, a
measured window, and (traced) the per-layer readings.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration and traffic; the
configuration's file holds the model's sizes and names its plain
reference (``portbench/<reference>.py``); ``portbench/traffic/<traffic>.json``
holds the job (mode, workers, batch, sequence, ...);
``portbench/limits/<cell>.json`` the limits of the comparison; and
``portbench/metrics/<metric>.py`` one reader per per-layer metric.

Of the program the harness uses the train step (``launch.steps``), the
lane mesh it runs on, its configuration schema and its kernels' names.
Parameters and batches are the benchmark's own, made from ``--seed``
and handed to the program and the reference alike.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import re
import statistics
import sys
import time
import typing
from pathlib import Path

import numpy as np
import torch

from . import counts, ref_dgs, tokens
from .ref_gqa import Precision, init_scale

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CHECKED_STEPS = 3


# ------------------------------------------------------------------ cells --

@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    per_layer: list          # BENCHMARK.json's per-layer entries it reports


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    return Cell(name=name, config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                per_layer=per_layer)


def reference(config: dict):
    return importlib.import_module(f"portbench.{config['reference']}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------- parameters --

def _leaf_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed % 2**64, i]).generate_state(
        1, np.uint64)[0] >> 1)


def make_leaf(layout, i: int, seed: int, device) -> torch.Tensor:
    """Leaf ``i`` of ``layout``, float32 on ``device``: a normal draw of a
    generator on the device seeded from (seed, i), scaled, or a
    constant."""
    _, shape, init = layout[i]
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, i))
    out = torch.empty(shape, device=device).normal_(generator=gen)
    return out.mul_(init_scale(shape, init))


def make_params(layout, seed: int, device) -> dict:
    return {path: make_leaf(layout, i, seed, device)
            for i, (path, _, _) in enumerate(layout)}


def to_tree(params: dict) -> dict:
    tree: dict = {}
    for path, t in params.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def leaf_of(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ---------------------------------------------------------------- program --

def _schema_part(cls, mapping: dict):
    """``cls`` built from ``mapping``: a value that is itself a mapping
    becomes the dataclass its field is annotated with (``MLAConfig``,
    ``MoEConfig``, ``SSMConfig``, ...).  A key that is no field raises."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for key, val in mapping.items():
        hint = hints.get(key)
        part = next((t for t in (hint, *typing.get_args(hint))
                     if dataclasses.is_dataclass(t)), None)
        if isinstance(val, dict) and part is not None:
            val = _schema_part(part, val)
        kw[key] = val
    return cls(**kw)


def port_config(config: dict):
    """The program's model configuration from the configuration file's
    fields of its schema, its nested parts as their dataclasses."""
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return _schema_part(ModelConfig,
                        {k: v for k, v in config.items() if k in names})


def build_program(cell: Cell, layout, device):
    """(the program's train step, its mesh); the program's parameter tree
    must have exactly the layout's leaves."""
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import abstract_params

    tr = cell.traffic
    cfg = port_config(cell.config)
    want = {path: tuple(shape) for path, shape, _ in layout}
    have = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                have[path + (key,)] = tuple(val.shape)
    walk(abstract_params(cfg), ())
    if have != want:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"benchmark's layout: {sorted(set(have) ^ set(want))}")
    mesh = LaneMesh(tr["workers"], device)
    ex = ExchangeConfig(mode=tr["mode"], density=tr["density"],
                        momentum=tr["momentum"], engine=tr["engine"],
                        quantize=tr["quantize"],
                        bucket_factor=tr.get("bucket_factor", 2.0))
    step = build_train_step(cfg, mesh, ex, lr=tr["lr"], remat=tr["remat"])
    return step, mesh


class WireCounter:
    """Bytes of the payloads one worker hands to and takes from the
    mesh's collectives (``gather``, ``all_to_all``, ``mean``; a
    collective inside another is the outer one's), counted from sizes
    alone on the mesh instance given."""

    def __init__(self, mesh):
        self.bytes = 0
        self._depth = 0
        lanes = len(mesh.lanes)
        for name, per_lane_out in (("gather", False), ("all_to_all", True),
                                   ("mean", False)):
            setattr(mesh, name, self._wrap(getattr(mesh, name), lanes,
                                           per_lane_out))

    def _wrap(self, fn, lanes, per_lane_out):
        def counted(x):
            self._depth += 1
            try:
                out = fn(x)
            finally:
                self._depth -= 1
            if self._depth == 0:
                taken = out.numel() * out.element_size()
                self.bytes += (x.numel() * x.element_size() // lanes
                               + (taken // lanes if per_lane_out else taken))
            return out
        return counted


class Timers:
    """CUDA events around the step's three parts (gradients, exchange,
    update), each part inside a profiler range of its name; installed
    on the step object alone."""

    PARTS = ("grads", "exchange", "apply")

    def __init__(self, step):
        self.events = {p: [] for p in self.PARTS}
        for part in self.PARTS:
            setattr(step, part, self._wrap(getattr(step, part), part))

    def _wrap(self, fn, part):
        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"bench/{part}"):
                start.record()
                out = fn(*args)
                end.record()
            self.events[part].append((start, end))
            return out
        return timed

    def total_ms(self, part) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events[part])


# ----------------------------------------------------------------- faults --

def plant(fault: str | None, step, mesh):
    """Break the timed path underneath, for the checks of the
    comparison: ``state_unchanged`` (the update is never applied),
    ``half_batch`` (each worker's gradient of the first half of its rows
    alone), ``no_exchange`` (each worker's collectives carry its own
    payload only)."""
    if fault is None:
        return
    if fault == "state_unchanged":
        step.apply = lambda params, updates: None
    elif fault == "half_batch":
        grads, W = step.grads, mesh.size

        def half(params, batch):
            t = batch["tokens"]
            b = t.shape[0] // W
            keep = torch.cat([t[w * b:w * b + b // 2] for w in range(W)])
            return grads(params, {"tokens": keep})
        step.grads = half
    elif fault == "no_exchange":
        def own(x):
            mask = torch.zeros(x.shape[:1] + (1,) * (x.dim() - 1),
                               dtype=x.dtype, device=x.device)
            mask[0] = 1
            return x * mask
        mesh.gather = own
        to_all = mesh.all_to_all

        def own_bucket(x):
            out = to_all(x)
            eye = torch.eye(out.shape[0], out.shape[1], device=x.device)
            eye = eye.reshape(eye.shape + (1,) * (out.dim() - 2))
            return torch.where(eye.bool(), out, torch.zeros_like(out)
                               if out.is_floating_point() else
                               torch.full_like(out, -1))
        mesh.all_to_all = own_bucket
    else:
        raise ValueError(f"unknown fault {fault!r}")


# ------------------------------------------------------------ comparison --

def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def _worst(gaps) -> float:
    """The largest gap, or infinity where any is not a number."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def worst_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between two norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    median = statistics.median(ref[p] for p in keep)
    return _worst(abs(prog[p] - ref[p]) / max(ref[p], median, 1e-30)
                  for p in keep)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``loss`` (the worst of the first three steps'
    relative loss gaps), ``grad`` (the worst leaf's gap of the velocity
    norm after step 1, which holds lr times the first gradient, its
    unsent part divided by m), ``change`` (the worst leaf's gap of the
    norm of the parameters' change over the three steps).  Leaves whose
    reference first gradient is under a thousandth of the median leaf's
    are left out of ``grad`` and ``change``.  A gap that is not a number
    is None."""
    g = ref["grad_norm"]
    med = statistics.median(g.values())
    keep = [p for p in g if g[p] >= 1e-3 * med]
    out = {"loss": _worst(abs(a - b) / abs(b)
                          for a, b in zip(prog["loss"], ref["loss"])),
           "grad": worst_gap(prog["velocity"], ref["velocity"], keep),
           "change": worst_gap(prog["change"], ref["change"], keep)}
    return {k: (v if math.isfinite(v) else None) for k, v in out.items()}


def change_norms(params: dict, layout, seed: int, device) -> dict:
    """Per leaf, the norm of ``params`` less the seed's initial value
    (made again leaf by leaf)."""
    out = {}
    for i, (path, _, _) in enumerate(layout):
        p0 = make_leaf(layout, i, seed, device)
        out[path] = _norm(params[path] - p0)
        del p0
    return out


def reference_readings(cell: Cell, layout, batches, seed: int, device,
                       precision: str = "bf16") -> dict:
    """The plain reference's three steps from the seed's parameters:
    losses, each leaf's first-gradient and velocity norm after step 1,
    and each leaf's change after step 3."""
    # the reference's float32 products stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference(cell.config)
    tr = cell.traffic
    W = tr["workers"]
    prec = Precision(precision)
    params = make_params(layout, seed, device)
    shapes = {path: shape for path, shape, _ in layout}
    cuts = {path: ref_dgs.cut(path, shape, tr["mode"], tr["density"], W,
                              tr.get("bucket_factor", 2.0))
            for path, shape, _ in layout}
    workers = [ref_dgs.Worker() for _ in range(W)]
    out = {"loss": []}
    for i in range(CHECKED_STEPS):
        toks = batches[i]["tokens"]
        b = toks.shape[0] // W
        losses, grads = [], []
        for w in range(W):
            loss, g = ref.loss_and_grads(params, toks[w * b:(w + 1) * b],
                                         cell.config, prec,
                                         rows_at_once=tr.get("reference_rows"))
            losses.append(loss)
            grads.append(g)
        out["loss"].append(sum(losses) / W)
        if i == 0:
            out["grad_norm"] = {p: math.sqrt(sum(_norm(g[p]) ** 2 for g in grads))
                                for p in shapes}
        for path in shapes:
            upd = ref_dgs.exchange_leaf(workers, path, [g.pop(path) for g in grads],
                                        shapes[path], cuts[path], tr["mode"],
                                        tr["momentum"], tr["lr"])
            params[path] -= upd
            del upd
        del grads
        if i == 0:
            out["velocity"] = {p: ref_dgs.velocity_norm(workers, p)
                               for p in shapes}
    del workers
    out["change"] = change_norms(params, layout, seed, device)
    return out


def checked_steps(step, tree, state, batches, layout, seed, device):
    """The program's first three steps, through the window's own call and
    feed: (its readings as :func:`reference_readings` gives them, the
    parameter tree, the exchange state)."""
    prog = {"loss": []}
    for i in range(CHECKED_STEPS):
        tree, state, loss = step(tree, state, batches[i])
        prog["loss"].append(loss)
        if i == 0:
            prog["velocity"] = {p: _norm(leaf_of(state.velocity, p))
                                for p, _, _ in layout}
    prog["loss"] = [float(x) for x in prog["loss"]]
    params = {p: leaf_of(tree, p) for p, _, _ in layout}
    prog["change"] = change_norms(params, layout, seed, device)
    return prog, tree, state


def _free(device):
    if torch.device(device).type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def readings(cell: Cell, seed: int, device, *, fault: str | None = None,
             control: bool = False) -> dict:
    """The comparison's numbers for one seed without a window: the
    program's three checked steps (with ``fault`` planted), or with
    ``control`` the reference computed in fp8 in the program's place,
    against the reference."""
    layout = reference(cell.config).layout(cell.config)
    batches = tokens.batches(cell.traffic, cell.config["vocab_size"], seed,
                             device)
    if control:
        prog = reference_readings(cell, layout, batches, seed, device,
                                  precision="fp8")
    else:
        step, mesh = build_program(cell, layout, device)
        plant(fault, step, mesh)
        tree = to_tree(make_params(layout, seed, device))
        state = step.init_state(tree)
        prog, tree, state = checked_steps(step, tree, state, batches,
                                          layout, seed, device)
        del step, mesh, tree, state
    _free(device)
    return compare(prog, reference_readings(cell, layout, batches, seed,
                                            device))


# -------------------------------------------------------------------- run --

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _kernel_names() -> list:
    """The program's own kernels: every ``__global__`` function of the
    sources its kernel table lists."""
    from repro_torch import kernels

    names = set()
    for info in kernels.KERNELS:
        src = (ROOT / info.source).read_text()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src))
    return sorted(names)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str | None = None, log=None) -> dict:
    """One run: set-up (build, parameters, batches, the three checked
    steps), the window, the traced readings, then the reference and the
    comparison.  Returns the result's fields."""
    from repro_torch import kernels

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    on_card = torch.device(device).type == "cuda"
    ref = reference(cell.config)
    layout = ref.layout(cell.config)
    tr = cell.traffic
    tokens_per_step = tr["batch"] * tr["seq"]

    step, mesh = build_program(cell, layout, device)
    wire = WireCounter(mesh)
    plant(fault, step, mesh)
    params = make_params(layout, seed, device)
    tree = to_tree(params)
    state = step.init_state(tree)
    batches = tokens.batches(tr, cell.config["vocab_size"], seed, device)
    prog, tree, state = checked_steps(step, tree, state, batches, layout,
                                      seed, device)

    timers = Timers(step) if trace else None
    kernels.reset_launches()
    wire.bytes = 0
    n, k = 0, CHECKED_STEPS
    losses = []
    # no collector pauses inside the window
    if on_card:
        gc.collect()
    gc.disable()
    try:
        _sync(device)
        t0 = time.perf_counter()
        while True:
            tree, state, loss = step(tree, state, batches[k % len(batches)])
            losses.append(loss)
            n += 1
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        t1 = time.perf_counter()
    finally:
        gc.enable()
    window_s = t1 - t0
    launches = {info.name: info.launches / n for info in kernels.KERNELS}
    wire_per_step = wire.bytes / n
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    log(f"window: {n} steps in {window_s:.6f} s, last loss "
        f"{float(losses[-1]):.6f}, launches a step {launches}")

    metrics, dev = {}, {}
    breakdown = None
    if trace:
        ctx = {"steps": n, "window_s": window_s,
               "flops_per_step": counts.train_step_flops(cell.config, layout, tr),
               "exchange_bytes_per_step": counts.exchange_least_bytes(layout, tr),
               "ms_total": {p: timers.total_ms(p) for p in Timers.PARTS}}
        if on_card:
            from .profile_reduce import profile_steps
            prof_steps = tr.get("profile_steps", 3)

            def one():
                nonlocal tree, state, k
                tree, state, _ = step(tree, state, batches[k % len(batches)])
                k += 1
            ctx["profile"] = profile_steps(one, prof_steps, _kernel_names())
            dev = {"busy_s": ctx["profile"]["busy_s"],
                   "window_s": ctx["profile"]["wall_s"]}
            breakdown = ctx["profile"]["breakdown"]
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics["tokens_per_s"] = {"value": n * tokens_per_step / window_s,
                                   "unit": "tokens/s"}
        metrics["wire_bytes_per_worker_step"] = {"value": wire_per_step,
                                                 "unit": "B"}
        metrics["setup_s"] = {"value": t0 - t_start, "unit": "s"}
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the program's state freed before the reference runs
    del tree, state, step, mesh, timers, losses, params, wire
    _free(device)
    t_ref = time.perf_counter()
    refr = reference_readings(cell, layout, batches, seed, device)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    numbers = compare(prog, refr)
    check = {name: {"value": numbers[name], "limit": cell.limits[name]}
             for name in ("loss", "grad", "change")}
    correct = failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in check.values())
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": peak, **dev}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result
