"""The model axis at a vocabulary that the model size does not divide, on
the CPU: the embedding split on ``d`` (``param_specs``' ``(None,
"model")``) with a whole head, and the embedding whole, against the JAX
reference's (2 data x 2 model) host mesh and against the port's own model
size 1 and ranks.

* ``LaneMesh(2, model=2)`` against the reference's (2, 2) mesh at
  vocabulary 513: the reduced chatglm3-6b (untied head), mamba2-780m (tied)
  and minicpm3-4b (MLA, untied; and at 3 heads, which do not split over 2
  shards, as minicpm3's 40 do not over 16: its ``wq_b`` and ``wkv_b`` are
  gathered); two allgather train steps under ``test_torch_train.py``'s
  support-swap rule, and the prefill and serve steps' float32 logits
  within 1e-4.
* Neither V nor d splitting (d 255): gradients and logits against model
  size 1.
* ``shard_params`` / ``unshard_leaf`` round-trip the ``d`` split.
* Four gloo ranks bit-equal to ``LaneMesh(2, model=2)``: the tied head
  reads the gathered table and the whole head's gradient is counted once.
"""
import dataclasses
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

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.convert import params_from_numpy, shard_params_from_numpy
from repro_torch.core.distributed import ExchangeConfig
from repro_torch.core.paramspace import tree_flatten, tree_unflatten
from repro_torch.launch import sharding
from repro_torch.launch.mesh import LaneMesh
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.models.model import abstract_params, init_params, prefill

from test_torch_train import _run_at_once, _steps_match_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, STEPS, GEN, VOCAB = 4, 20, 2, 3, 513
# arch, or arch:heads for its reduced config at that many heads
ARCHS = ("chatglm3-6b", "mamba2-780m", "minicpm3-4b", "minicpm3-4b:3")

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, sys
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

    out, archs, vocab = sys.argv[2], sys.argv[3].split(","), int(sys.argv[4])
    B, S, steps, gen, lr = 4, 20, 2, 3, 0.05
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))

    def flat(tree, prefix, res):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[prefix + "/".join(p.key for p in path)] = np.asarray(x)

    for arch in archs:
        name, _, heads = arch.partition(":")
        cfg = dataclasses.replace(get_arch(name).reduced(vocab=vocab),
                                  compute_dtype="float32")
        if heads:
            cfg = dataclasses.replace(cfg, n_heads=int(heads))
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
        state = init_exchange_state(params, ex_cfg, 2)
        losses = []
        with mesh:
            step = bundle.jit()
            for i in range(steps):
                params, state, loss = step(
                    params, state, {"tokens": jnp.asarray(res["tokens"][i])})
                losses.append(float(loss))
                flat(params, f"p{i + 1}/", res)
                flat(state.velocity, f"v{i + 1}/", res)
        res["losses"] = np.asarray(losses)
        np.savez(f"{out}/train_{arch}.npz", **res)

        L = S + gen + 1
        params = init_params(jax.random.PRNGKey(0), cfg)
        res = {}
        flat(params, "p/", res)
        res["tokens"] = np.random.default_rng(5).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        pre = build_prefill_step(cfg, mesh,
                                 shape=InputShape("p", S, B, "prefill"))
        srv = build_serve_step(cfg, mesh,
                               shape=InputShape("d", L, B, "decode"))

        def pad(path, x):
            if path[-1].name not in ("k", "v", "c_kv", "k_rope") \\
                    or x.shape[2] != S:
                return x
            return jnp.pad(x, [(0, 0), (0, 0), (0, L - S)]
                           + [(0, 0)] * (x.ndim - 3))

        with mesh:
            logits, caches = pre.jit()(
                params, {"tokens": jnp.asarray(res["tokens"])})
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
    """The reference on its (2, 2) mesh at vocabulary 513: per arch, two
    allgather train steps (parameters and velocities after each), and the
    prefill's last logits and three greedy decode steps.  Two processes
    at once take half the archs each."""
    out = tmp_path_factory.mktemp("jax_vocab_axis")
    _run_at_once([[sys.executable, "-c", _JAX_SCRIPT, str(ROOT / "src"),
                   str(out), ",".join(archs), str(VOCAB)]
                  for archs in (ARCHS[0::2], ARCHS[1::2])], out)
    return {name.stem: dict(np.load(name)) for name in out.glob("*.npz")}


def _reduced(arch):
    """``arch`` (or ``arch:heads``) reduced at vocabulary 513."""
    name, _, heads = arch.partition(":")
    cfg = get_arch(name).reduced(vocab=VOCAB)
    return dataclasses.replace(cfg, n_heads=int(heads)) if heads else cfg


def _cfg(arch, **changes):
    return dataclasses.replace(_reduced(arch), compute_dtype="float32",
                               **changes)


def _specs(cfg, M):
    return dict(zip(*reversed(tree_flatten(
        sharding.param_specs(cfg, abstract_params(cfg), M)))))


def _tree(res, prefix):
    flat = {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}
    paths = tuple(tuple(k.split("/")) for k in flat)
    return tree_unflatten(paths, list(flat.values()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference_at_odd_vocab(ref, arch):
    """At vocabulary 513 the spec puts the embedding on ``d`` and keeps
    ``lm_head`` whole; two allgather steps on ``LaneMesh(2, model=2)``
    against the reference's (2, 2) mesh under the support-swap rule of
    ``test_torch_train.py`` (losses rtol 1e-4, parameters atol 1e-4 but
    at swaps)."""
    cfg = _cfg(arch)
    specs = _specs(cfg, 2)
    assert specs[("embed", "table")] == (None, "model")
    assert specs.get(("lm_head", "w"), (None, None)) == (None, None)
    _steps_match_reference(ref[f"train_{arch}"], arch, steps=STEPS,
                           mesh=LaneMesh(2, "cpu", model=2), cfg=cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference_at_odd_vocab(ref, arch):
    """``build_prefill_step`` and ``build_serve_step`` on ``LaneMesh(2,
    model=2)`` at vocabulary 513 against the reference's (2, 2) mesh: the
    prefill's last logits and three decode steps (the reference's greedy
    tokens), float32, within rtol/atol 1e-4."""
    res = ref[f"serve_{arch}"]
    cfg = _cfg(arch)
    mesh = LaneMesh(2, "cpu", model=2)
    params = params_from_numpy(_tree(res, "p/"), "cpu")
    pre = build_prefill_step(cfg, mesh, shape=InputShape("p", S, B,
                                                         "prefill"))
    srv = build_serve_step(cfg, mesh, shape=InputShape("d", S + GEN + 1, B,
                                                       "decode"))
    local = pre.local_params(params)
    tokens = torch.from_numpy(res["tokens"])
    logits, _ = pre(local, {"tokens": tokens})
    assert logits.shape == (B, 1, VOCAB)
    np.testing.assert_allclose(logits.numpy(), res["logits0"], rtol=1e-4,
                               atol=1e-4)
    _, caches, _ = prefill(local, tokens, cfg, max_len=S + GEN + 1,
                           tp=mesh.model)
    for g in range(GEN):
        logits, caches = srv(local, caches,
                             torch.from_numpy(res[f"tok{g}"]), S + g)
        np.testing.assert_allclose(logits.numpy(), res[f"logits{g + 1}"],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {g}")


@pytest.mark.parametrize("arch", ("chatglm3-6b", "command-r-35b"))
def test_whole_embedding_against_model_size_one(arch):
    """Neither V (513) nor d (255) splits over 2: the embedding and the
    head stay whole (one lookup, logits computed once; chatglm3's
    ``lm_head``, command-r's tied table).  Gradients within 2e-5 of each
    leaf's largest and the same losses (rtol 1e-6), prefill and decode
    logits atol 1e-5, against model size 1."""
    cfg = _cfg(arch, d_model=255)
    specs = _specs(cfg, 2)
    assert specs[("embed", "table")] == (None, None)
    params = init_params(cfg, seed=3, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, VOCAB, (4, 16)).astype(np.int32))}
    grads, losses, logits = {}, {}, {}
    for m in (1, 2):
        mesh = LaneMesh(2, "cpu", model=m)
        step = build_train_step(cfg, mesh, ExchangeConfig(mode="allgather"),
                                remat=False)
        g, losses[m] = step.grads(params, batch)
        grads[m] = tree_flatten(g)[0]
        pre = build_prefill_step(cfg, mesh,
                                 shape=InputShape("p", 16, 4, "prefill"))
        srv = build_serve_step(cfg, mesh,
                               shape=InputShape("d", 20, 4, "decode"))
        local = pre.local_params(params)
        _, caches, _ = prefill(local, batch["tokens"], cfg, max_len=20,
                               tp=mesh.model)
        outs = [pre(local, batch)[0]]
        for t in range(3):
            outs.append(srv(local, caches, batch["tokens"][:, t:t + 1],
                            16 + t)[0])
        logits[m] = outs
    np.testing.assert_allclose(losses[2].numpy(), losses[1].numpy(),
                               rtol=1e-6)
    for a, b in zip(grads[1], grads[2]):
        assert float((a - b).abs().max()) <= 2e-5 * float(a.abs().max())
    for a, b in zip(logits[1], logits[2]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


@pytest.mark.parametrize("M", (2, 16))
def test_shard_params_round_trip_on_d(M):
    """At model size M the spec cuts the (513, d) table into M column
    pieces: ``shard_params`` gives shard m the columns ``m d/M .. (m+1)
    d/M`` (the numpy loader ``shard_params_from_numpy`` the same bits),
    and ``unshard_leaf`` joins the pieces into the table bit for bit."""
    cfg = _cfg("mamba2-780m")
    specs = sharding.param_specs(cfg, abstract_params(cfg), M)
    spec = _specs(cfg, M)[("embed", "table")]
    assert spec == (None, "model")
    params = init_params(cfg, seed=2, device="cpu")
    table = params["embed"]["table"]
    numpy_tree = tree_unflatten(tree_flatten(params)[1], [
        x.numpy() for x in tree_flatten(params)[0]])
    c = cfg.d_model // M
    pieces = []
    for m in range(M):
        piece = sharding.shard_params(params, specs, m, M)["embed"]["table"]
        assert piece.shape == (VOCAB, c) and piece.is_contiguous()
        assert torch.equal(piece, table[:, m * c:(m + 1) * c])
        loaded = shard_params_from_numpy(numpy_tree, cfg, m, M, "cpu")
        assert torch.equal(loaded["embed"]["table"], piece)
        pieces.append(piece)
    whole = sharding.unshard_leaf(pieces, spec)
    assert torch.equal(whole.view(torch.int32), table.view(torch.int32))


# ------------------------------------------------------------ the ranks --

RANK_ARCHS = ("mamba2-780m", "minicpm3-4b:3")

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, hashlib, json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np, torch
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.core.paramspace import tree_flatten
    from repro_torch.launch import mesh as mesh_lib, sharding
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import (abstract_params, decode_step,
                                          init_params, prefill)

    rank, world, init, out = (int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    archs, vocab = json.loads(sys.argv[6]), int(sys.argv[7])
    mesh = mesh_lib.init_process_mesh(rank, world, init, "cpu", model=2)
    m = mesh.model.rank
    res = {}
    for arch in archs:
        name, _, heads = arch.partition(":")
        cfg = get_arch(name).reduced(vocab=vocab)
        if heads:
            cfg = dataclasses.replace(cfg, n_heads=int(heads))
        specs = sharding.param_specs(cfg, abstract_params(cfg), 2)
        step = build_train_step(cfg, mesh, ExchangeConfig(
            mode="allgather", density=0.05), lr=0.05, remat=False)
        params = sharding.shard_params(init_params(cfg, seed=0,
                                                   device="cpu"), specs, m, 2)
        state = step.init_state(params)
        rng = np.random.default_rng(9)
        for i in range(2):
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, vocab, (4, 16)).astype(np.int32))}
            params, state, loss = step(params, state, batch)
            res[f"{arch}/loss{i}"] = loss.numpy()
        leaves, paths = tree_flatten(params)
        vel = tree_flatten(state.velocity)[0]
        for path, x, v in zip(paths, leaves, vel):
            res[f"{arch}/p/" + "/".join(path)] = x.numpy()
            res[f"{arch}/v/" + "/".join(path)] = v.numpy()
        local = [params]
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, vocab, (2, 12)).astype(np.int32))
        logits, caches, _ = prefill(local, tokens, cfg, max_len=15,
                                    tp=mesh.model)
        res[f"{arch}/serve0"] = logits.numpy()
        for g in range(3):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, caches = decode_step(local, caches, tok, 12 + g, cfg,
                                         tp=mesh.model)
            res[f"{arch}/serve{g + 1}"] = logits.numpy()
    np.savez(out, **res)
    mesh.close()
    torch.distributed.destroy_process_group()
""")

RANK_DEADLINE = 300


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of four gloo ranks on a (2 data, 2 model)
    ``ProcessMesh`` at vocabulary 513: two allgather train steps, then a
    prefill and three greedy decode steps, per rank arch."""
    tmp = tmp_path_factory.mktemp("vocab_ranks")
    world = 4
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_SCRIPT, str(ROOT / "src"),
                 str(r), str(world), f"file://{tmp}/rendezvous",
                 str(tmp / f"rank{r}.npz"), json.dumps(RANK_ARCHS),
                 str(VOCAB)],
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


def _bits(got, want, what):
    """A rank's array bit-equal to the lanes' (a lone loss may come as a
    scalar on one side and a one-element vector on the other)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.size > 1:
        assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(
        np.ascontiguousarray(got).reshape(-1).view(np.uint8),
        np.ascontiguousarray(want).reshape(-1).view(np.uint8), err_msg=what)


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_ranks_equal_lanes_at_odd_vocab(ranks, arch):
    """Two allgather train steps and a prefill with three greedy decode
    steps at vocabulary 513 (embedding on ``d``; mamba2's tied head reads
    the gathered table, minicpm3's ``lm_head`` is whole and its 3 MLA
    heads run whole on each shard): every rank holds
    ``LaneMesh(2, model=2)``'s shards of the parameters and its lane's
    velocity, the same losses and the same logits, bit for bit."""
    from repro_torch.models.model import decode_step
    from repro_torch.launch.steps import _local_params
    cfg = _reduced(arch)
    step = build_train_step(cfg, LaneMesh(2, "cpu", model=2),
                            ExchangeConfig(mode="allgather", density=0.05),
                            lr=0.05, remat=False)
    params = init_params(cfg, seed=0, device="cpu")
    state = step.init_state(params)
    rng = np.random.default_rng(9)
    losses = []
    for _ in range(2):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, VOCAB, (4, 16)).astype(np.int32))}
        params, state, loss = step(params, state, batch)
        losses.append(loss.numpy())
    mesh = LaneMesh(1, "cpu", model=2)
    local = _local_params(params, cfg, mesh)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, VOCAB, (2, 12)).astype(np.int32))
    logits, caches, _ = prefill(local, tokens, cfg, max_len=15,
                                tp=mesh.model)
    served = [logits]
    for g in range(3):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        logits, caches = decode_step(local, caches, tok, 12 + g, cfg,
                                     tp=mesh.model)
        served.append(logits)
    specs = _specs(cfg, 2)
    leaves, paths = tree_flatten(params)
    vel = tree_flatten(state.velocity)[0]
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        for i in range(2):
            _bits(got[f"{arch}/loss{i}"], losses[i], f"rank {r} loss {i}")
        for path, x, v in zip(paths, leaves, vel):
            key = "/".join(path)
            spec = specs[path]
            _bits(got[f"{arch}/p/{key}"],
                  sharding.shard_leaf(x, spec, m, 2).numpy(),
                  f"rank {r} {key}")
            _bits(got[f"{arch}/v/{key}"],
                  sharding.shard_leaf(v[d:d + 1], (None,) + spec, m,
                                      2).numpy(),
                  f"rank {r} velocity {key}")
        for g, x in enumerate(served):
            _bits(got[f"{arch}/serve{g}"], x.numpy(),
                  f"rank {r} {arch} serve step {g}")
