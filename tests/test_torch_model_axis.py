"""The port's ``"model"`` mesh axis (tensor and expert parallelism) on the
CPU, against the JAX reference's (2 data x 2 model) host mesh and against
the port's own model size 1.

* The training launcher's ``--devices 8`` trains the reference's (4, 2)
  mesh, and its run equals ``build_train_step`` on ``LaneMesh(4,
  model=2)`` bit for bit.
* The exchange on a rank of the model axis selects exactly model size 1's
  rows of its shard (allgather and shardedps; a hinted 2-D leaf, a folded
  stacked leaf, a sharded vector cut whole), from the same gradients.
* ``LaneMesh(2, model=2)`` against the reference's (2, 2) mesh: two
  allgather train steps under ``test_torch_train.py``'s support-swap rule
  (every family the axis reaches), and the prefill and serve steps'
  float32 logits within 1e-4 (all ten architectures).
* The attention's head layouts against model size 1: a shard boundary
  inside a head (6 heads over 4 shards), and K/V projections that do not
  split (each shard reading one KV head, or straddling KV groups).
* ``LaneMesh(2, model=2)`` bit-equal to four gloo ranks.

The reference runs once for the file in a subprocess with four host
devices (they must be set before JAX is imported), the ranks once in four
subprocesses.
"""
import dataclasses
import hashlib
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, shard_params_from_numpy
from repro_torch.core import distributed as tdist
from repro_torch.core.paramspace import tree_flatten, tree_unflatten
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import sharding
from repro_torch.launch.mesh import LaneMesh
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.models.model import abstract_params, init_params, prefill

from test_torch_train import _run_at_once, _steps_match_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, STEPS, GEN = 4, 20, 2, 3
TRAIN_ARCHS = ("chatglm3-6b", "qwen3-moe-235b-a22b", "minicpm3-4b",
               "mamba2-780m", "zamba2-2.7b")
SERVE_ARCHS = ("chatglm3-6b", "command-r-35b", "gemma3-12b", "qwen2-vl-7b",
               "musicgen-large", "qwen3-moe-235b-a22b", "dbrx-132b",
               "minicpm3-4b", "mamba2-780m", "zamba2-2.7b")

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, sys
    # one thread a device: the file's processes share the CPU
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.configs.shapes import InputShape, input_specs
    from repro.core.distributed import ExchangeConfig
    from repro.launch import mesh as mesh_lib
    from repro.launch.steps import (build_prefill_step, build_serve_step,
                                    build_train_step, init_exchange_state)
    from repro.models import init_params

    out = sys.argv[2]
    train_archs, serve_archs = ([a for a in arg.split(",") if a]
                                for arg in sys.argv[3:5])
    B, S, steps, gen, lr = 4, 20, 2, 3, 0.05
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))

    def flat(tree, prefix, res):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[prefix + "/".join(p.key for p in path)] = np.asarray(x)

    for arch in train_archs:
        cfg = dataclasses.replace(get_arch(arch).reduced(),
                                  compute_dtype="float32")
        ex_cfg = ExchangeConfig(mode="allgather", density=0.05, momentum=0.9,
                                engine="exact")
        bundle = build_train_step(
            cfg, mesh, ex_cfg, lr=lr, remat=False,
            batch_specs_abstract=input_specs(cfg,
                                             InputShape("t", S, B, "train")))
        params = init_params(jax.random.PRNGKey(0), cfg)
        res = {}
        flat(params, "p0/", res)
        rng = np.random.default_rng(11)
        res["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (steps, B, S)).astype(np.int32)
        batches = [{"tokens": jnp.asarray(t)} for t in res["tokens"]]
        state = init_exchange_state(params, ex_cfg, 2)
        losses = []
        with mesh:
            step = bundle.jit()
            for i in range(steps):
                params, state, loss = step(params, state, batches[i])
                losses.append(float(loss))
                flat(params, f"p{i + 1}/", res)
                flat(state.velocity, f"v{i + 1}/", res)
        res["losses"] = np.asarray(losses)
        np.savez(f"{out}/train_{arch}.npz", **res)

    L = S + gen + 1
    for arch in serve_archs:
        cfg = dataclasses.replace(get_arch(arch).reduced(),
                                  compute_dtype="float32")
        params = init_params(jax.random.PRNGKey(0), cfg)
        res = {}
        flat(params, "p/", res)
        rng = np.random.default_rng(5)
        res["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, S)).astype(np.int32)
        batch = {"tokens": jnp.asarray(res["tokens"])}
        if cfg.frontend_tokens:
            res["frontend_embeds"] = rng.normal(
                size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
            batch["frontend_embeds"] = jnp.asarray(res["frontend_embeds"])
        pre = build_prefill_step(cfg, mesh,
                                 shape=InputShape("p", S, B, "prefill"))
        srv = build_serve_step(cfg, mesh,
                               shape=InputShape("d", L, B, "decode"))

        def pad(path, x):
            # the linear KV and MLA caches get decode's room
            if path[-1].name not in ("k", "v", "c_kv", "k_rope") \\
                    or x.shape[2] != S:
                return x
            return jnp.pad(x, [(0, 0), (0, 0), (0, L - S)]
                           + [(0, 0)] * (x.ndim - 3))

        with mesh:
            logits, caches = pre.jit()(params, batch)
            # on the host: the serve step lays them out itself
            caches = jax.device_get(
                jax.tree_util.tree_map_with_path(pad, caches))
            step = srv.jit()
            res["logits0"] = np.asarray(logits)
            for g in range(gen):
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(
                    jnp.int32)
                res[f"tok{g}"] = np.asarray(tok)
                logits, caches = step(params, caches, tok, jnp.int32(S + g))
                res[f"logits{g + 1}"] = np.asarray(logits)
        np.savez(f"{out}/serve_{arch}.npz", **res)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results on its (2, 2) mesh: per train arch, two
    allgather steps (parameters and velocities after each); per serve
    arch, the prefill's last logits and three greedy decode steps.  Three
    processes at once take half the train archs each and the serve
    archs."""
    out = tmp_path_factory.mktemp("jax_model_axis")
    _run_at_once([[sys.executable, "-c", _JAX_SCRIPT, str(ROOT / "src"),
                   str(out), train, serve]
                  for train, serve in ((",".join(TRAIN_ARCHS[0::2]), ""),
                                       (",".join(TRAIN_ARCHS[1::2]), ""),
                                       ("", ",".join(SERVE_ARCHS)))], out)
    return {name.stem: dict(np.load(name)) for name in out.glob("*.npz")}


def _cfg(arch):
    return dataclasses.replace(get_arch(arch).reduced(),
                               compute_dtype="float32")


# --------------------------------------------------------- the launcher --

def test_launcher_trains_the_reference_mesh(tmp_path):
    """``--devices 8`` builds the reference's (4 data, 2 model) mesh, as
    ``repro.launch.train`` does (``model_par = 2`` when the device count
    is even), and its losses and final parameters are those of
    ``build_train_step`` on ``LaneMesh(4, model=2)``, bit for bit."""
    ckpt = tmp_path / "final.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--devices", "8", "--steps", "3", "--batch", "8", "--seq", "32",
         "--checkpoint", str(ckpt)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout + proc.stderr
    assert "mesh={'data': 4, 'model': 2}" in out, out[-2000:]
    printed = re.findall(r"step +\d+ loss=([0-9.]+)", out)

    from repro_torch.core.distributed import ExchangeConfig
    cfg = get_arch("chatglm3-6b").reduced()
    step = build_train_step(cfg, LaneMesh(4, "cpu", model=2),
                            ExchangeConfig(mode="allgather", density=0.05,
                                           momentum=0.9),
                            lr=0.05, remat=False)
    params = init_params(cfg, seed=0, device="cpu")
    state = step.init_state(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=32, batch_size=8,
                         seed=0, device="cpu")
    losses = []
    for i in range(3):
        params, state, loss = step(params, state, stream.batch(i))
        losses.append(f"{float(loss):.4f}")
    assert printed == losses, (printed, losses)
    saved, meta = load_checkpoint(str(ckpt), params)
    assert meta["step"] == 3
    for a, b in zip(tree_flatten(saved)[0], tree_flatten(params)[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------- against the reference --

@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_match_reference_on_2x2(ref, arch):
    """The port's ``LaneMesh(2, model=2)`` against the reference's (2, 2)
    mesh: two allgather steps, each from the reference's state, under the
    support-swap rule of ``test_torch_train.py``."""
    _steps_match_reference(ref[f"train_{arch}"], arch, steps=STEPS,
                           mesh=LaneMesh(2, "cpu", model=2))


def _tree(res, prefix):
    flat = {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}
    paths = tuple(tuple(k.split("/")) for k in flat)
    return tree_unflatten(paths, list(flat.values()))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_steps_match_reference_on_2x2(ref, arch):
    """``build_prefill_step`` and ``build_serve_step`` on ``LaneMesh(2,
    model=2)`` against the reference's on its (2, 2) mesh: the prefill's
    last logits and three decode steps (the reference's greedy tokens),
    float32, within rtol/atol 1e-4."""
    res = ref[f"serve_{arch}"]
    cfg = _cfg(arch)
    mesh = LaneMesh(2, "cpu", model=2)
    params = params_from_numpy(_tree(res, "p/"), "cpu")
    from repro_torch.configs.shapes import InputShape
    pre = build_prefill_step(cfg, mesh, shape=InputShape("p", S, B,
                                                         "prefill"))
    srv = build_serve_step(cfg, mesh, shape=InputShape("d", S + GEN + 1, B,
                                                       "decode"))
    local = pre.local_params(params)
    fe = res.get("frontend_embeds")
    fe = None if fe is None else torch.from_numpy(fe)
    batch = {"tokens": torch.from_numpy(res["tokens"])}
    if fe is not None:
        batch["frontend_embeds"] = fe
    logits, _ = pre(local, batch)
    np.testing.assert_allclose(logits.numpy(), res["logits0"], rtol=1e-4,
                               atol=1e-4)
    _, caches, _ = prefill(local, batch["tokens"], cfg, frontend_embeds=fe,
                           max_len=S + GEN + 1, tp=mesh.model)
    for g in range(GEN):
        logits, caches = srv(local, caches,
                             torch.from_numpy(res[f"tok{g}"]), S + g)
        np.testing.assert_allclose(logits.numpy(), res[f"logits{g + 1}"],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {g}")


# ------------------------------------------------------- head layouts --

@pytest.mark.parametrize("heads, kv_heads, M", [
    (6, 2, 4),      # a shard boundary inside a head
    (4, 2, 4),      # K/V whole, each shard reads one KV head
    (12, 3, 2),     # K/V whole, a shard's heads straddle KV groups
], ids=["split-head", "kv-whole", "kv-expanded"])
def test_head_layouts_against_model_size_one(heads, kv_heads, M):
    """The attention's layouts at model size M against model size 1 (the
    reduced chatglm3 with ``heads`` query and ``kv_heads`` KV heads,
    float32): a split head gathers the queries and attends whole before
    the row-parallel ``wo``; where the KV heads do not split, the K/V
    projections stay whole and each shard reads the KV heads its query
    heads map to.  Gradients within 2e-5 of each leaf's largest, prefill
    and decode logits atol 1e-5."""
    cfg = dataclasses.replace(get_arch("chatglm3-6b").reduced(),
                              compute_dtype="float32", n_heads=heads,
                              n_kv_heads=kv_heads, d_model=64 * heads)
    specs = dict(zip(*reversed(tree_flatten(
        sharding.param_specs(cfg, abstract_params(cfg), M)))))
    assert specs[("units", "b0", "attn", "wq", "w")] == (None, None, "model")
    assert (specs[("units", "b0", "attn", "wk", "w")] == (None, None, None)
            ) == bool(kv_heads % M)
    params = init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))}
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.distributed import ExchangeConfig
    grads, logits = {}, {}
    for m in (1, M):
        mesh = LaneMesh(2, "cpu", model=m)
        step = build_train_step(cfg, mesh, ExchangeConfig(mode="allgather"),
                                remat=False)
        grads[m] = tree_flatten(step.grads(params, batch)[0])[0]
        pre = build_prefill_step(cfg, mesh,
                                 shape=InputShape("p", 16, 4, "prefill"))
        srv = build_serve_step(cfg, mesh,
                               shape=InputShape("d", 20, 4, "decode"))
        local = pre.local_params(params)
        _, caches, _ = prefill(local, batch["tokens"], cfg, max_len=20,
                               tp=mesh.model)
        outs = [pre(local, batch)[0]]
        tok = batch["tokens"][:, :1]
        for g in range(3):
            outs.append(srv(local, caches, tok, 16 + g)[0])
        logits[m] = outs
    for a, b in zip(grads[1], grads[M]):
        assert float((a - b).abs().max()) <= 2e-5 * float(a.abs().max())
    for a, b in zip(logits[1], logits[M]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch, M", [
    ("chatglm3-6b", 2), ("chatglm3-6b", 4), ("gemma3-12b", 2),
    ("minicpm3-4b", 2), ("mamba2-780m", 2), ("zamba2-2.7b", 2),
])
def test_zero_caches_decode_against_model_size_one(arch, M):
    """``init_caches(..., tp=)`` gives each shard the caches its decode
    writes (its KV heads, or the KV heads it reads; the whole MLA latent;
    its SSM heads, the whole conv window): four decode steps from zero
    caches at model size M against model size 1, float32 logits atol
    1e-5."""
    from repro_torch.models.model import decode_step, init_caches
    from repro_torch.launch.steps import _local_params
    cfg = _cfg(arch)
    params = init_params(cfg, seed=5, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 4)).astype(np.int32))
    logits = {}
    for m in (1, M):
        mesh = LaneMesh(1, "cpu", model=m)
        local = params if m == 1 else _local_params(params, cfg, mesh)
        caches = init_caches(cfg, 2, 8, device="cpu", tp=mesh.model)
        out = []
        for t in range(4):
            lg, caches = decode_step(local, caches, tokens[:, t:t + 1], t,
                                     cfg, tp=mesh.model)
            out.append(lg)
        logits[m] = out
    for a, b in zip(logits[1], logits[M]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


# -------------------------------------------------------------- the ranks --

# name -> (whole shape, hint): a replicated leaf, a sharded vector (cut
# whole: allgather's flat branch, shardedps' one-row view), a hinted 2-D
# leaf, a stacked one, and a stacked one whose rows fold (rest > 2^22)
LEAVES = {
    "a_rep": ((2, 24), None),
    "b_vec": ((24,), 0),
    "c_w": ((24, 40), 1),
    "d_stack": ((2, 16, 24), 2),
    "e_fold": ((2, 2097153, 2), 2),
}
HINTS = [LEAVES[name][1] for name in sorted(LEAVES)]
CASES = {
    "allgather": dict(mode="allgather", engine="exact", density=0.1),
    "allgather-int8": dict(mode="allgather", engine="exact", density=0.1,
                           quantize="int8"),
    "shardedps-int8": dict(mode="shardedps", engine="exact", density=0.1,
                           quantize="int8", bucket_factor=1.0),
}
W, M, LR = 2, 2, 0.1
# the families whose prefill and decode run on the ranks: dense GQA with
# K/V sharded, MoE, MLA, Mamba2, the hybrid
RANK_SERVE_ARCHS = ["chatglm3-6b", "qwen3-moe-235b-a22b", "minicpm3-4b",
                    "mamba2-780m", "zamba2-2.7b"]

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, hashlib, json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np, torch
    from repro_torch.configs import get_arch
    from repro_torch.convert import shard_params_from_numpy
    from repro_torch.core import distributed as tdist
    from repro_torch.core.paramspace import tree_flatten
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.sharding import shard_leaf
    from repro_torch.launch.steps import build_train_step

    rank, world, init, params_path, out = (
        int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
        sys.argv[6])
    leaves, cases = json.loads(sys.argv[7]), json.loads(sys.argv[8])
    names = sorted(leaves)
    hints = [leaves[n][1] for n in names]
    mesh = mesh_lib.init_process_mesh(rank, world, init, "cpu", model=2)
    d, m = mesh.rank, mesh.model.rank

    def mine(x, ax):
        return x if ax is None else x.chunk(2, ax)[m].contiguous()

    # the test's gradients (``_grads``), drawn again from their seed
    rng = np.random.default_rng(21)
    grads = {n: rng.normal(size=(2, 2) + tuple(leaves[n][0])).astype(
        np.float32) for n in leaves}
    res = {}
    for case, kw in cases.items():
        cfg = tdist.ExchangeConfig(momentum=0.7, **kw)
        params = {n: mine(torch.zeros(leaves[n][0]), leaves[n][1])
                  for n in names}
        state = tdist.init_state(params, cfg, mesh.size, lanes=1,
                                 shard_axes=hints, model=mesh.model)
        for s in range(2):
            g = {n: mine(torch.from_numpy(grads[n][s, d:d + 1].copy()),
                         None if leaves[n][1] is None else leaves[n][1] + 1)
                 for n in names}
            upd, state = tdist.exchange(state, g, cfg=cfg, lr=0.1,
                                        mesh=mesh, shard_axes=hints)
            for n in names:
                res[f"{case}/upd{s}/{n}"] = upd[n].numpy()
        for n in names:
            res[f"{case}/vel/{n}"] = state.velocity[n].numpy()
            res[f"{case}/m/{n}"] = state.m_shard[n].numpy()
        if kw["mode"] == "shardedps":
            res[f"{case}/ovf"] = state.overflow.numpy()
    # two allgather train steps of the reduced chatglm3 on the (2, 2) mesh,
    # this rank's shard loaded straight from the numpy parameters
    cfg = get_arch("chatglm3-6b").reduced()
    step = build_train_step(cfg, mesh, tdist.ExchangeConfig(
        mode="allgather", density=0.05), lr=0.05, remat=False)
    def _nested(flat):
        leaves, paths = flat
        tree = {}
        for path, val in zip(paths, leaves):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.asarray(val)
        return tree

    flat = dict(np.load(params_path))
    params = shard_params_from_numpy(
        _nested((list(flat.values()),
                 [tuple(k.split("/")) for k in flat])), cfg, m, 2, "cpu")
    state = step.init_state(params)
    rng = np.random.default_rng(9)
    for i in range(2):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32))}
        params, state, loss = step(params, state, batch)
        res[f"train/loss{i}"] = loss.numpy()
    leaves_, paths = tree_flatten(params)
    for path, x in zip(paths, leaves_):
        res["train/p/" + "/".join(path)] = x.numpy()
    for path, x in zip(paths, tree_flatten(state.velocity)[0]):
        res["train/v/" + "/".join(path)] = x.numpy()
    # prefill and three greedy decode steps of each serving family
    from repro_torch.models.model import decode_step, init_params, prefill
    for arch in json.loads(sys.argv[9]):
        cfg = get_arch(arch).reduced()
        local = [shard_params_from_numpy(_nested(tree_flatten(
            init_params(cfg, seed=1, device="cpu"))), cfg, m, 2, "cpu")]
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 12)).astype(np.int32))
        logits, caches, _ = prefill(local, tokens, cfg, max_len=15,
                                    tp=mesh.model)
        res[f"serve/{arch}/0"] = logits.numpy()
        for g in range(3):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, caches = decode_step(local, caches, tok, 12 + g, cfg,
                                         tp=mesh.model)
            res[f"serve/{arch}/{g + 1}"] = logits.numpy()
    # a big array as the SHA-256 of its bytes
    for key in [k for k, v in res.items() if np.asarray(v).size > 1 << 20]:
        arr = np.ascontiguousarray(res.pop(key))
        res[key + "#sha"] = np.frombuffer(
            hashlib.sha256(arr.tobytes()).digest(), np.uint8)
    np.savez(out, **res)
    mesh.close()
    torch.distributed.destroy_process_group()
""")

RANK_DEADLINE = 600


def _grads():
    """Two steps' gradients of the W workers (the rank script draws the
    same from the same seed)."""
    rng = np.random.default_rng(21)
    return {n: rng.normal(size=(2, W) + shape).astype(np.float32)
            for n, (shape, _) in LEAVES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of four gloo ranks on a (2 data, 2 model)
    ``ProcessMesh``: the exchange cases, and two chatglm3 train steps."""
    tmp = tmp_path_factory.mktemp("model_ranks")
    cfg = get_arch("chatglm3-6b").reduced()
    leaves, paths = tree_flatten(init_params(cfg, seed=0, device="cpu"))
    np.savez(tmp / "params.npz", **{"/".join(p): x.numpy()
                                    for p, x in zip(paths, leaves)})
    world = W * M
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    leaves_json = {n: [list(shape), hint] for n, (shape, hint)
                   in LEAVES.items()}
    for r, path in enumerate(logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_SCRIPT, str(ROOT / "src"),
                 str(r), str(world), f"file://{tmp}/rendezvous",
                 str(tmp / "params.npz"),
                 str(tmp / f"rank{r}.npz"), json.dumps(leaves_json),
                 json.dumps(CASES), json.dumps(RANK_SERVE_ARCHS)],
                stdout=out, stderr=subprocess.STDOUT, env=env))
    start = time.monotonic()
    while any(p.poll() is None for p in procs) \
            and not any(p.poll() for p in procs) \
            and time.monotonic() - start < RANK_DEADLINE:
        time.sleep(0.1)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    errs = [(r, proc.returncode, path.read_text()[-3000:])
            for r, (proc, path) in enumerate(zip(procs, logs))]
    assert all(proc.returncode == 0 for proc in procs), errs
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _bits(res, key, want, what):
    """``res[key]`` (a rank's result) bit-equal to ``want``; a big array
    comes as the SHA-256 of its bytes (``key#sha``)."""
    want = np.asarray(want).copy(order="C")
    if key + "#sha" in res:
        digest = hashlib.sha256(want.tobytes()).digest()
        assert bytes(res[key + "#sha"]) == digest, what
        return
    got = np.asarray(res[key])
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(
        np.ascontiguousarray(got).reshape(-1).view(np.uint8),
        np.ascontiguousarray(want).reshape(-1).view(np.uint8), err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_exchange_selects_model_size_one_rows_per_shard(ranks, case):
    """With the same gradients, a rank of the (2, 2) mesh ends with its
    shard of model size 1's update, velocity and M rows, bit for bit: the
    shard selects exactly model size 1's selection in its rows (the
    whole-cut vector is gathered, selected whole on every shard), and the
    shardedps overflow counts every shard's rows."""
    grads = _grads()
    cfg = tdist.ExchangeConfig(momentum=0.7, **CASES[case])
    mesh = LaneMesh(W, "cpu")
    names = sorted(LEAVES)
    params = {n: torch.zeros(LEAVES[n][0]) for n in names}
    state = tdist.init_state(params, cfg, W, lanes=W, shard_axes=HINTS)
    want = {}
    for s in range(2):
        upd, state = tdist.exchange(
            state, {n: torch.from_numpy(grads[n][s]) for n in names},
            cfg=cfg, lr=LR, mesh=mesh, shard_axes=HINTS)
        for n in names:
            want[f"upd{s}/{n}"] = upd[n]
    selected = 0
    for r, got in enumerate(ranks):
        d, m = divmod(r, M)
        for n in names:
            ax = LEAVES[n][1]

            def piece(x, dim):
                return x if ax is None else x.chunk(M, dim)[m]

            for s in range(2):
                _bits(got, f"{case}/upd{s}/{n}",
                      piece(want[f"upd{s}/{n}"], ax).numpy(),
                      f"rank {r} step {s} update {n}")
            _bits(got, f"{case}/vel/{n}",
                  piece(state.velocity[n][d:d + 1], (ax or 0) + 1).numpy(),
                  f"rank {r} velocity {n}")
            rows = ax is not None and len(LEAVES[n][0]) > 1
            m_want = state.m_shard[n][d:d + 1]
            _bits(got, f"{case}/m/{n}",
                  (m_want.chunk(M, 1)[m] if rows else m_want).numpy(),
                  f"rank {r} M {n}")
            selected += int(np.count_nonzero(piece(want[f"upd0/{n}"], ax)))
        if cfg.mode == "shardedps":
            _bits(got, f"{case}/ovf", state.overflow[d:d + 1].numpy(),
                  f"rank {r} overflow")
            assert int(state.overflow.sum()) > 0, "no bucket overflowed"
    assert selected > 0


def test_process_mesh_equals_lanes_with_model_axis(ranks):
    """Two allgather train steps of the reduced chatglm3: each of four
    gloo ranks (its shard loaded straight from the numpy parameters by
    ``shard_params_from_numpy``) holds exactly ``LaneMesh(2, model=2)``'s
    shard of the parameters and its lane's shard of the velocity, and
    the same losses."""
    from repro_torch.core.distributed import ExchangeConfig
    cfg = get_arch("chatglm3-6b").reduced()
    step = build_train_step(cfg, LaneMesh(W, "cpu", model=M),
                            ExchangeConfig(mode="allgather", density=0.05),
                            lr=0.05, remat=False)
    params = init_params(cfg, seed=0, device="cpu")
    state = step.init_state(params)
    rng = np.random.default_rng(9)
    losses = []
    for _ in range(2):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32))}
        params, state, loss = step(params, state, batch)
        losses.append(loss.numpy())
    specs = dict(zip(*reversed(tree_flatten(sharding.param_specs(
        cfg, abstract_params(cfg), M)))))
    leaves, paths = tree_flatten(params)
    vel = tree_flatten(state.velocity)[0]
    for r, got in enumerate(ranks):
        d, m = divmod(r, M)
        for i in range(2):
            _bits(got, f"train/loss{i}", losses[i], f"rank {r} loss {i}")
        for path, x, v in zip(paths, leaves, vel):
            key = "/".join(path)
            spec = specs[path]
            _bits(got, "train/p/" + key,
                  sharding.shard_leaf(x, spec, m, M).contiguous().numpy(),
                  f"rank {r} {key}")
            _bits(got, "train/v/" + key,
                  sharding.shard_leaf(v[d], spec, m, M)[None].contiguous()
                  .numpy(), f"rank {r} velocity {key}")


@pytest.mark.parametrize("arch", RANK_SERVE_ARCHS)
def test_process_mesh_serves_as_the_lanes(ranks, arch):
    """Prefill and three greedy decode steps at model size 2: every rank
    (its shards loaded by ``shard_params_from_numpy``, its caches its own)
    gives ``LaneMesh(1, model=2)``'s logits bit for bit."""
    from repro_torch.models.model import decode_step
    cfg = get_arch(arch).reduced()
    from repro_torch.launch.steps import _local_params
    mesh = LaneMesh(1, "cpu", model=M)
    local = _local_params(init_params(cfg, seed=1, device="cpu"), cfg, mesh)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    logits, caches, _ = prefill(local, tokens, cfg, max_len=15,
                                tp=mesh.model)
    want = [logits]
    for g in range(3):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        logits, caches = decode_step(local, caches, tok, 12 + g, cfg,
                                     tp=mesh.model)
        want.append(logits)
    for r, got in enumerate(ranks):
        for g, x in enumerate(want):
            _bits(got, f"serve/{arch}/{g}", x.numpy(),
                  f"rank {r} {arch} step {g}")
