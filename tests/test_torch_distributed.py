"""The port's mesh exchanges (dense, allgather, shardedps) on the CPU,
against the JAX reference's and against each other.

* Every mode on a ``LaneMesh(4)`` against the reference's exchange under
  ``shard_map`` on a (4, 1) host mesh, from the same numpy gradients, two
  steps so the velocity, M and v carry: bit for bit in allgather and
  shardedps (exact and blockwise engines, quantize none and int8, wire
  float32 and bfloat16, each value in each mode; the overflow count too),
  dense at rtol 1e-6.  The
  reference runs in one subprocess per file (its host devices must be set
  before JAX is imported) and leaves its results in an ``.npz``.
* The reference's identities on the port: allgather equals the serial
  per-worker ``leaf_update`` sum; shardedps equals allgather when nothing
  constrains it.
* ``ProcessMesh`` over gloo, one subprocess per rank at W = 2 and 4, gives
  the ``LaneMesh`` result bit for bit in every mode, and
  ``shard_exchange_batch(use_mesh=True)`` the one-card leg's.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as tdist
from repro_torch.core.paramspace import ShardSpec
from repro_torch.core.samomentum import leaf_update
from repro_torch.launch.mesh import LaneMesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = 4
STEPS = 2
LR = 0.1
MOMENTUM = 0.7
# name -> (per-worker shape, shard hint): the exchange's branches -- flat
# leaves (no hint), moved and stacked row views, a table, stacked biases
# (rows of two).  No 1-D leaf has a hint: the reference's shardedps gives
# one a unit dim more (its moveaxis of the one-row view) and then computes
# another program; the model's hinted leaves all have two dims or more.
LEAVES = {
    "a_norm": ((2, 24), None),
    "b_scale": ((24,), None),
    "c_w": ((24, 40), 1),
    "d_stack": ((2, 16, 24), 2),
    "e_table": ((30, 16), 0),
    "f_stackb": ((2, 24), 1),
}
HINTS = [LEAVES[name][1] for name in sorted(LEAVES)]
# name -> ExchangeConfig fields.  Per sparse mode, three (engine,
# quantize, wire dtype) cases that hold each of those values at least
# once: every blockwise case costs the reference's interpreted kernels
# about 13 s of compilation
CASES = {"dense": dict(mode="dense")}
for _mode in ("allgather", "shardedps"):
    for _engine, _quant, _wire in (("exact", "none", "float32"),
                                   ("exact", "int8", "bfloat16"),
                                   ("blockwise", "int8", "float32")):
        CASES[f"{_mode}-{_engine}-{_quant}-{_wire}"] = dict(
            mode=_mode, engine=_engine, quantize=_quant, wire_dtype=_wire)
for _name, _kw in CASES.items():
    _kw.update(density=0.25, momentum=MOMENTUM)
    if _kw["mode"] == "shardedps":
        _kw["bucket_factor"] = 1.0     # tight buckets: entries overflow
CASES["shardedps-exact-secondary"] = dict(
    mode="shardedps", engine="exact", density=0.25, momentum=MOMENTUM,
    secondary_density=0.5)

_JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core import distributed as D
    from repro.launch import mesh as mesh_lib

    leaves, cases, out = json.loads(sys.argv[2]), json.loads(sys.argv[3]), \\
        sys.argv[4]
    names = sorted(leaves)
    hints = [leaves[n][1] for n in names]
    W, steps, lr = 4, 2, 0.1
    rng = np.random.default_rng(7)
    grads = {n: rng.normal(size=(steps, W) + tuple(leaves[n][0])).astype(
        np.float32) for n in names}
    res = {f"grad/{n}": g for n, g in grads.items()}
    mesh = mesh_lib.make_mesh((W, 1), ("data", "model"))
    for case, kw in cases.items():
        cfg = D.ExchangeConfig(**kw)
        sharded = kw["mode"] == "shardedps"
        shard = {n: D.shardedps_state_size(tuple(leaves[n][0]), leaves[n][1],
                                           W) if sharded else 0
                 for n in names}
        state = D.ExchangeState(
            velocity={n: jnp.zeros((W,) + tuple(leaves[n][0])) for n in names},
            m_shard={n: jnp.zeros((W, shard[n])) for n in names},
            v_shard={n: jnp.zeros((W, shard[n])) for n in names},
            overflow=jnp.zeros((W,), jnp.int32) if sharded else ())

        def inner(st, g):
            st = jax.tree.map(lambda x: x[0], st)
            g = jax.tree.map(lambda x: x[0], g)
            upd, st = D.exchange(st, g, cfg=cfg, lr=lr,
                                 axis_names=("data",), n_workers=W,
                                 shard_axes=hints)
            return upd, jax.tree.map(lambda x: x[None], st)

        spec = jax.tree.map(lambda _: P("data"), state)
        step = jax.jit(jax.shard_map(
            inner, mesh=mesh, axis_names={"data"},
            in_specs=(spec, P("data")), out_specs=(P(), spec),
            check_vma=False))
        for s in range(steps):
            upd, state = step(state, {n: grads[n][s] for n in names})
            for n in names:
                res[f"{case}/upd{s}/{n}"] = np.asarray(upd[n])
        for n in names:
            res[f"{case}/vel/{n}"] = np.asarray(state.velocity[n])
            res[f"{case}/m/{n}"] = np.asarray(state.m_shard[n])
            res[f"{case}/v/{n}"] = np.asarray(state.v_shard[n])
        if kw["mode"] == "shardedps":
            res[f"{case}/ovf"] = np.asarray(state.overflow)
    np.savez(out, **res)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results of every case (and the gradients), computed
    once for the file in a subprocess with four host devices."""
    out = tmp_path_factory.mktemp("jax_exchange") / "ref.npz"
    leaves = {n: [list(shape), hint] for n, (shape, hint) in LEAVES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(ROOT / "src"),
         json.dumps(leaves), json.dumps(CASES), str(out)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _grads(ref, step):
    """One step's gradients, ``(W, *shape)`` a leaf, as torch tensors."""
    return {n: torch.from_numpy(ref[f"grad/{n}"][step].copy())
            for n in sorted(LEAVES)}


def _run_port(ref, case, mesh=None):
    """The case's two steps through the port's exchange on ``mesh``
    (default a LaneMesh of W lanes on the CPU), worker w taking the
    reference's worker w's gradients; returns the results under the
    reference's keys."""
    mesh = mesh or LaneMesh(W, "cpu")
    cfg = tdist.ExchangeConfig(**CASES[case])
    params = {n: torch.zeros(shape) for n, (shape, _) in LEAVES.items()}
    state = tdist.init_state(params, cfg, mesh.size, lanes=len(mesh.lanes),
                             shard_axes=HINTS)
    out = {}
    for s in range(STEPS):
        g = {n: x[list(mesh.lanes)] for n, x in _grads(ref, s).items()}
        upd, state = tdist.exchange(state, g, cfg=cfg, lr=LR, mesh=mesh,
                                    shard_axes=HINTS)
        for n in sorted(LEAVES):
            out[f"{case}/upd{s}/{n}"] = upd[n]
    for n in sorted(LEAVES):
        out[f"{case}/vel/{n}"] = state.velocity[n]
        out[f"{case}/m/{n}"] = state.m_shard[n]
        out[f"{case}/v/{n}"] = state.v_shard[n]
    if cfg.mode == "shardedps":
        out[f"{case}/ovf"] = state.overflow
    return out


def _bits_equal(port: torch.Tensor, want: np.ndarray, what: str):
    got = port.contiguous().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.astype(np.float32).view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("case", [c for c in CASES if c != "dense"])
def test_exchange_bit_equal_to_reference(ref, case):
    got = _run_port(ref, case)
    for key, val in got.items():
        _bits_equal(val, ref[key], key)
    if CASES[case]["mode"] == "shardedps":
        assert int(got[f"{case}/ovf"].sum()) > 0 \
            or "secondary" in case, "tight buckets overflowed nowhere"


def test_dense_exchange_matches_reference(ref):
    got = _run_port(ref, "dense")
    for key, val in got.items():
        np.testing.assert_allclose(val.numpy(), ref[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_allgather_matches_serial_leaf_updates():
    """The reference's identity: the mesh allgather aggregates to the
    serial per-worker ``leaf_update`` sum."""
    W8, n = 8, 64
    rng = np.random.default_rng(0)
    grads = torch.from_numpy(rng.normal(size=(W8, n)).astype(np.float32))
    cfg = tdist.ExchangeConfig(mode="allgather", density=0.25, momentum=0.5)
    state = tdist.init_state({"p": torch.zeros(n)}, cfg, W8, lanes=W8)
    upd, _ = tdist.exchange(state, {"p": grads}, cfg=cfg, lr=0.1,
                            mesh=LaneMesh(W8, "cpu"))
    k = max(1, round(0.25 * n))
    agg = np.zeros(n)
    for w in range(W8):
        msg, _ = leaf_update(torch.zeros(n), grads[w], momentum=0.5, lr=0.1,
                             k=k)
        np.add.at(agg, msg.indices.numpy(), msg.values.numpy())
    np.testing.assert_allclose(upd["p"].numpy(), agg / W8, atol=1e-5)


def test_shardedps_equals_allgather_when_unconstrained():
    """With a bucket for every entry and a dense downward pass, shardedps
    delivers the allgather update and velocity, and M == v on every
    shard (nothing left in the difference)."""
    W8, n = 8, 64
    rng = np.random.default_rng(0)
    grads = torch.from_numpy(rng.normal(size=(W8, n)).astype(np.float32))
    mesh = LaneMesh(W8, "cpu")
    out = {}
    for mode, kw in (("allgather", {}),
                     ("shardedps", dict(bucket_factor=float(W8),
                                        secondary_density=1.0))):
        cfg = tdist.ExchangeConfig(mode=mode, density=0.25, momentum=0.5,
                                   **kw)
        state = tdist.init_state({"p": torch.zeros(n)}, cfg, W8, lanes=W8)
        upd, state = tdist.exchange(state, {"p": grads}, cfg=cfg, lr=0.1,
                                    mesh=mesh)
        out[mode] = (upd["p"], state)
    (upd_ag, st_ag), (upd_sp, st_sp) = out["allgather"], out["shardedps"]
    np.testing.assert_allclose(upd_sp.numpy(), upd_ag.numpy(), atol=1e-5)
    np.testing.assert_allclose(st_sp.velocity["p"].numpy(),
                               st_ag.velocity["p"].numpy(), atol=1e-5)
    np.testing.assert_allclose(st_sp.m_shard["p"].numpy(),
                               st_sp.v_shard["p"].numpy(), atol=1e-6)
    assert int(st_sp.overflow.sum()) == 0


# (whole leaf's shape, hint): a hint on dim 0 and on a later dim, a stack
# whose rows fold a leading dim, 1-D hinted leaves under and over allgather's
# flat bound of 1 << 24, and unhinted leaves
RULE_LEAVES = [((30, 16), 0), ((24, 40), 1), ((2, 16, 24), 2),
               ((8, 1024, 8192), 0), ((24,), 0), ((1 << 25,), 0),
               ((24, 40), None), ((1 << 25,), None)]


@pytest.mark.parametrize("where", ["lanes", "rank0", "rank1"])
@pytest.mark.parametrize("leaf", RULE_LEAVES, ids=str)
@pytest.mark.parametrize("mode", ["allgather", "shardedps"])
def test_model_axis_rule_equals_both_old_branches(mode, leaf, where):
    """On shapes alone, at a model axis of 2: the one rule of both sparse
    exchanges (run as is, gathered whole, or the rank's rows) is each
    mode's own former branch condition, and "rows" keeps the whole leaf's
    cut with the rank's share of its rows."""
    from repro_torch.launch.mesh import ModelAxis

    full, ax = leaf
    model = ModelAxis(2, rank=None if where == "lanes" else int(where[-1]))
    on_rank = not model.lanes
    shape = (full if ax is None or not on_rank
             else full[:ax] + (full[ax] // 2,) + full[ax + 1:])
    cfg = tdist.ExchangeConfig(mode=mode, density=0.01)
    cut = tdist.leaf_cut(full, ax, cfg, W)
    if mode == "allgather":
        want = ("as is" if not on_rank or ax is None
                else "whole" if cut.flat else "rows")
    else:
        want = ("rows" if on_rank and ax is not None and len(full) > 1
                else "whole" if on_rank and ax is not None else "as is")
    how, got = tdist.model_axis_rule(shape, ax, cfg, W, model)
    assert how == want
    assert got == (cut._replace(S=cut.S // 2) if how == "rows" else cut)


# ---------------------------------------------------------------- ranks --

MESH_CASES = ("dense", "allgather-blockwise-int8-float32",
              "shardedps-exact-int8-bfloat16", "shardedps-blockwise-int8-float32")

_RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core import distributed as tdist
    from repro_torch.core.paramspace import ShardSpec
    from repro_torch.launch.mesh import init_process_mesh
    sys.path.insert(0, sys.argv[2])
    import test_torch_distributed as T

    rank, world, init, ref_path, out = (int(sys.argv[3]), int(sys.argv[4]),
                                        sys.argv[5], sys.argv[6], sys.argv[7])
    mesh = init_process_mesh(rank, world, init, "cpu")
    ref = dict(np.load(ref_path))
    res = {}
    for case in T.MESH_CASES:
        for key, val in T._run_port(ref, case, mesh).items():
            res[key] = val.numpy()
    spec, idx, vals = T._route_problem(world)
    ri, rv, ovf = tdist.shard_exchange_batch(spec, idx, vals, use_mesh=True,
                                             mesh=mesh)
    res.update(route_ri=ri.numpy(), route_rv=rv.numpy(),
               route_ovf=ovf.numpy())
    np.savez(out, **res)
    torch.distributed.destroy_process_group()
""")


def _route_problem(S: int):
    """(spec, indices, values) of a batch of 5 messages over S shards, with
    padding and -0.0 planted."""
    rng = np.random.default_rng(60 + S)
    spec = ShardSpec.even(97, S)
    B, k = 5, 13
    idx = np.stack([rng.permutation(97)[:k] for _ in range(B)]).astype(
        np.int32)
    idx[rng.random((B, k)) < 0.15] = -1
    vals = rng.normal(size=(B, k)).astype(np.float32)
    vals[:, 1::3] = -0.0
    return spec, torch.from_numpy(idx), torch.from_numpy(vals)


RANK_DEADLINE = 600     # seconds for all ranks (alone: about 7 s)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, ref, tmp_path_factory):
    """(W, every rank's results): one process per rank, a ProcessMesh over
    gloo (a file rendezvous, so files running in parallel never share a
    port).  Each rank writes its output to a file, so no rank blocks on a
    full pipe while the test waits on another."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{world}")
    ref_path = tmp / "ref.npz"
    np.savez(ref_path, **{k: v for k, v in ref.items()
                          if k.startswith("grad/")})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_SCRIPT, str(ROOT / "src"),
                 str(ROOT / "tests"), str(r), str(world),
                 f"file://{tmp}/rendezvous", str(ref_path),
                 str(tmp / f"rank{r}.npz")],
                stdout=out, stderr=subprocess.STDOUT, env=env))
    # every rank at once, to one deadline: a rank that fails ends the
    # others (which would wait for it in a collective), and its error is
    # what the assert shows
    start = time.monotonic()
    while any(p.poll() is None for p in procs) \
            and not any(p.poll() for p in procs) \
            and time.monotonic() - start < RANK_DEADLINE:
        time.sleep(0.1)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    seconds = time.monotonic() - start
    errs = [(r, proc.returncode, path.read_text()[-3000:])
            for r, (proc, path) in enumerate(zip(procs, logs))]
    assert all(proc.returncode == 0 for proc in procs), (
        f"world {world} after {seconds:.1f} s (deadline {RANK_DEADLINE} s)",
        errs)
    return world, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("case", MESH_CASES)
def test_process_mesh_equals_lane_mesh(ref, ranks, case):
    """Each rank's update equals the lanes' and its state is its lane's,
    bit for bit."""
    world, results = ranks
    want = _run_port(ref, case, LaneMesh(world, "cpu"))
    for rank, got in enumerate(results):
        for key, val in want.items():
            lane = val if "/upd" in key else val[rank:rank + 1]
            _bits_equal(lane, got[key], f"rank {rank} {key}")


def test_shard_exchange_batch_over_ranks_equals_one_card(ranks):
    world, results = ranks
    spec, idx, vals = _route_problem(world)
    ri, rv, ovf = tdist.shard_exchange_batch(spec, idx, vals)
    for got in results:
        _bits_equal(ri, got["route_ri"], "local indices")
        _bits_equal(rv, got["route_rv"], "values")
        assert int(ovf) == int(got["route_ovf"]) == 0
