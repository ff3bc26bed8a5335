"""The port's data-parallel training path on the CPU: ``build_train_step``
on a ``LaneMesh`` against the JAX reference's on a (4, 1) host mesh, the
reference's own DP identities and loss rule on the port, and the launcher
(lanes, and one process per worker under torchrun).

The reference runs in a subprocess (its host devices must be set before
JAX is imported) from the same numpy parameters and tokens, and leaves its
losses and final parameters in an ``.npz``.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.baselines import msgd_step
from repro_torch.core.distributed import ExchangeConfig, leaf_cut
from repro_torch.core.engine import velocity_accumulate
from repro_torch.core.paramspace import (tree_flatten, tree_leaves,
                                         tree_unflatten)
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.mesh import LaneMesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import init_params, loss_fn

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, STEPS, LR = 8, 32, 3, 0.05

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.configs.shapes import InputShape, input_specs
    from repro.core.distributed import ExchangeConfig
    from repro.launch import mesh as mesh_lib
    from repro.launch.steps import build_train_step, init_exchange_state
    from repro.models import init_params

    out, arch, steps = sys.argv[2], sys.argv[3], int(sys.argv[4])
    B, S, lr = 8, 32, 0.05
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype="float32")
    mesh = mesh_lib.make_mesh((4, 1), ("data", "model"))
    ex_cfg = ExchangeConfig(mode="allgather", density=0.05, momentum=0.9,
                            engine="exact")
    bundle = build_train_step(
        cfg, mesh, ex_cfg, lr=lr, remat=False,
        batch_specs_abstract=input_specs(cfg, InputShape("t", S, B, "train")))
    params = init_params(jax.random.PRNGKey(0), cfg)
    res = {f"p0/{'/'.join(p.key for p in path)}": np.asarray(x)
           for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (steps, B, S)).astype(np.int32)
    res["tokens"] = tokens
    batches = [{"tokens": jnp.asarray(tokens[i])} for i in range(steps)]
    if cfg.frontend_tokens:
        fe = rng.normal(size=(steps, B, cfg.frontend_tokens, cfg.d_model))
        res["frontend_embeds"] = fe.astype(np.float32)
        for i, batch in enumerate(batches):
            batch["frontend_embeds"] = jnp.asarray(res["frontend_embeds"][i])
    state = init_exchange_state(params, ex_cfg, 4)
    losses = []
    with mesh:
        step = bundle.jit()
        for i in range(steps):
            params, state, loss = step(params, state, batches[i])
            losses.append(float(loss))
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
                res[f"p{i + 1}/{'/'.join(p.key for p in path)}"] = \
                    np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(
                    state.velocity)[0]:
                res[f"v{i + 1}/{'/'.join(p.key for p in path)}"] = \
                    np.asarray(x)
    res["losses"] = np.asarray(losses)
    np.savez(out, **res)
""")


def _reference_runs(tmp_path_factory, archs, steps=STEPS):
    """Per arch of ``archs``, the reference's ``steps`` allgather steps on
    the reduced arch (float32 compute): its initial parameters, tokens
    (and a modality family's frontend embeddings), losses and the
    parameters and the workers' velocities after each step.  The archs
    run in processes of their own, all at once."""
    out = tmp_path_factory.mktemp("jax_train")
    _run_at_once([[sys.executable, "-c", _JAX_SCRIPT, str(ROOT / "src"),
                   str(out / f"{arch}.npz"), arch, str(steps)]
                  for arch in archs], out)
    return {arch: dict(np.load(out / f"{arch}.npz")) for arch in archs}


def _run_at_once(argvs, out):
    """Run the reference's commands ``argvs`` (``JAX_PLATFORMS=cpu``) as
    processes at once, each one's stderr in a file under ``out``; assert
    that each exits with 0 within 600 s."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    logs = [out / f"stderr{i}.txt" for i in range(len(argvs))]
    procs = []
    try:
        for argv, log in zip(argvs, logs):
            with open(log, "w") as err:
                procs.append(subprocess.Popen(
                    argv, stdout=subprocess.DEVNULL, stderr=err, env=env))
        for proc, log in zip(procs, logs):
            proc.wait(timeout=600)
            assert proc.returncode == 0, log.read_text()[-4000:]
    finally:
        for proc in procs:
            proc.kill()


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return _reference_runs(tmp_path_factory,
                           ["chatglm3-6b", "qwen3-moe-235b-a22b"])


@pytest.fixture(scope="module")
def ref(refs):
    return refs["chatglm3-6b"]


@pytest.fixture(scope="module")
def moe_ref(refs):
    return refs["qwen3-moe-235b-a22b"]


def _tree(ref, prefix):
    """The reference's parameters under ``prefix`` as the port's tree."""
    flat = {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}
    paths = tuple(tuple(k.split("/")) for k in flat)
    return params_from_numpy(tree_unflatten(paths, list(flat.values())),
                             "cpu")


TIE = 1e-5     # how near a support swap lies to its row's boundary


def _tie_gaps(step, velocity, grads):
    """Per leaf, a pair of ``(L, *shape)`` arrays over the lanes: each
    coordinate's distance from its row's selection boundary on that lane,
    relative to the row's k-th magnitude, and its magnitude ``a = |m * u
    + lr * g|`` there.  With ``t_k >= t_k1`` the row's k_row-th and
    (k_row + 1)-th magnitudes, the distance is 0 where ``t_k1 <= a <=
    t_k`` and otherwise how far ``a`` lies outside, over ``t_k`` (inf
    where the row selects every coordinate).  A coordinate that two runs
    select differently on a lane although their accumulations differ by
    rounding alone lies within that rounding of the boundary there."""
    out = []
    for u, g, ax in zip(tree_leaves(velocity), tree_leaves(grads),
                        step.hints):
        shape = tuple(u.shape[1:])
        c = leaf_cut(shape, ax, step.ex_cfg, step.mesh.size)
        moved = shape if c.ax is None else \
            (shape[c.ax],) + shape[:c.ax] + shape[c.ax + 1:]
        gaps, accs = [], []
        for lane in range(u.shape[0]):
            a = velocity_accumulate(u[lane], g[lane],
                                    momentum=step.ex_cfg.momentum,
                                    lr=step.lr).abs()
            accs.append(a.numpy())
            if c.k_row >= c.rest:
                gaps.append(np.full(shape, np.inf))
                continue
            a = a.reshape(c.S, c.rest) if c.ax is None else \
                a.movedim(c.ax, 0).reshape(c.S, c.rest)
            top = a.topk(c.k_row + 1, dim=1).values
            tk, tk1 = top[:, c.k_row - 1:c.k_row], top[:, c.k_row:]
            gap = (torch.maximum(tk - a, a - tk1).clamp(min=0)
                   / torch.where(tk > 0, tk, 1.0)).reshape(moved)
            gaps.append((gap if c.ax is None else gap.movedim(0, c.ax))
                        .numpy())
        out.append((np.stack(gaps), np.stack(accs)))
    return out


def test_train_steps_match_reference(ref):
    """Three allgather steps (exact engine, float32 compute) on four lanes
    against the reference's on four host devices: the losses of the
    port's own three steps to rtol 1e-4, and each step from the
    reference's parameters and velocities to atol 1e-4.

    The two frameworks' float32 gradients differ in their last bits, and a
    top-k whose k-th and (k+1)-th magnitudes lie that close picks the other
    one on a lane: a *support swap*.  It moves that coordinate's update by
    that lane's share of the mean, ``a / W`` with ``a = |m * u + lr * g|``
    on the lane, whether or not another lane selects it too, and that
    lane's velocity by ``a (1/m - 1)``: SAMomentum keeps a sent
    coordinate's accumulation and divides an unsent one's by m.  A
    coordinate outside the atol must be one:
    the difference is one lane's share (to 1e-3 relative), and that lane
    lay within ``TIE`` (relative) of its row's selection boundary, where
    the reference's accumulation differs by rounding alone (measured on
    this problem: 9.3e-7, about 8 float32 ulps; the boundary's k-th and
    (k+1)-th magnitudes lie about 7e-3 apart on the median row).  At most
    one coordinate in 10,000 may be excused so.

    Each step starts from the reference's state because a swap changes
    more than rounding: it moves the parameter, and it resets the lane's
    velocity on one side only, so from the port's own state a later
    step's near-ties in that row lie up to 7.5e-3 (relative) from the
    boundary (measured on this problem), and no rounding bound holds
    them."""
    _steps_match_reference(ref, "chatglm3-6b")


def test_moe_train_steps_match_reference(moe_ref):
    """The same for the reduced qwen3-moe-235b-a22b (4 experts, top-4,
    dense dispatch): its loss includes the router's aux losses, and its
    expert leaves (units, E, d, f) are cut along the expert axis, under
    the same support-swap rule."""
    _steps_match_reference(moe_ref, "qwen3-moe-235b-a22b")


ATOL = 1e-4


def _swaps(diff, lanes, scale, what):
    """Where ``diff > ATOL``: assert that each such coordinate is a swap
    on some lane (``lanes``: that lane's distances and magnitudes, ``(L,
    *shape)``), its difference the lane's magnitude over ``scale``;
    return how many there are."""
    bad = diff > ATOL
    gap, share = lanes[0][..., bad], lanes[1][..., bad] / scale
    ok = (gap <= TIE) & (np.abs(diff[bad] - share) <= 1e-3 * share + 1e-6)
    ok = ok.any(0) if ok.ndim > 1 else ok
    assert ok.all(), (what, "no lane's swap at its row's boundary",
                      diff[bad][~ok][:4], share[..., ~ok].T[:4],
                      gap[..., ~ok].T[:4])
    return int(bad.sum())


def _steps_match_reference(ref, arch, steps=STEPS, mesh=None, cfg=None):
    """Hold the port's steps on ``mesh`` (default a ``LaneMesh(4)``) to
    the reference's under the support-swap rule; returns the leaves' paths
    and how many parameters each excused over the steps.  ``cfg``
    defaults to ``arch``'s reduced config in float32."""
    cfg = cfg or dataclasses.replace(get_arch(arch).reduced(),
                                     compute_dtype="float32")
    ex_cfg = ExchangeConfig(mode="allgather", density=0.05, momentum=0.9,
                            engine="exact")
    step = build_train_step(cfg, mesh or LaneMesh(4, "cpu"), ex_cfg, lr=LR,
                            remat=False)
    W = step.mesh.size
    batches = [{"tokens": torch.from_numpy(ref["tokens"][i])}
               for i in range(steps)]
    for i, batch in enumerate(batches):
        if "frontend_embeds" in ref:
            batch["frontend_embeds"] = torch.from_numpy(
                ref["frontend_embeds"][i])
    # the port's own steps: their losses
    params = _tree(ref, "p0/")
    state = step.init_state(params)
    losses = []
    for batch in batches:
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"][:steps], rtol=1e-4)
    # each step from the reference's parameters and velocities
    want = [tree_flatten(_tree(ref, f"p{i}/"))[0] for i in range(steps + 1)]
    paths = tree_flatten(params)[1]
    assert tree_flatten(_tree(ref, "p0/"))[1] == paths
    excused = dict.fromkeys(paths, 0)
    for i, batch in enumerate(batches):
        params = _tree(ref, f"p{i}/")
        state = step.init_state(params)
        if i:
            for v, path in zip(tree_flatten(state.velocity)[0], paths):
                v.copy_(torch.from_numpy(ref[f"v{i}/" + "/".join(path)]))
        # the gradients the step computes (the same bits)
        lanes = _tie_gaps(step, state.velocity, step.grads(params, batch)[0])
        params, state, _ = step(params, state, batch)
        for j, (path, x, v) in enumerate(zip(
                paths, tree_flatten(params)[0],
                tree_flatten(state.velocity)[0])):
            name = f"step {i} {'/'.join(path)}"
            diff = ((x - want[i][j]) - (want[i + 1][j] - want[i][j])).abs()
            excused[path] += _swaps(diff.numpy(), lanes[j], W, name)
            # on its lane a swap keeps the accumulation a in one run and
            # divides it by m in the other
            vdiff = (v - torch.from_numpy(
                ref[f"v{i + 1}/" + "/".join(path)])).abs().numpy()
            m = ex_cfg.momentum
            for lane in range(W):
                _swaps(vdiff[lane], (lanes[j][0][lane], lanes[j][1][lane]),
                       m / (1.0 - m), f"{name} velocity lane {lane}")
    total = sum(x.numel() for x in want[0])
    print(f"support swaps outside the atol: {sum(excused.values())} of "
          f"{total} parameters over {steps} steps: "
          f"{ {'/'.join(p): n for p, n in excused.items() if n} }")
    assert sum(excused.values()) <= total // 10_000, (excused, total)
    return paths, excused


def test_dense_mode_equals_single_worker_msgd():
    """The classic DP equivalence, as the reference's: dense exchange on
    four lanes == momentum SGD on the whole batch (the reduced
    musicgen-large, with its frame embeddings)."""
    cfg = get_arch("musicgen-large").reduced()
    ex_cfg = ExchangeConfig(mode="dense", momentum=0.7)
    step = build_train_step(cfg, LaneMesh(4, "cpu"), ex_cfg, lr=0.1,
                            remat=False)
    params = init_params(cfg, seed=0, device="cpu")
    ref_params = tree_unflatten(tree_flatten(params)[1],
                                [x.clone() for x in tree_flatten(params)[0]])
    ref_vel = tree_unflatten(tree_flatten(params)[1],
                             [torch.zeros_like(x)
                              for x in tree_flatten(params)[0]])
    state = step.init_state(params)
    rng = np.random.default_rng(1)
    for _ in range(3):
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)),
            "frontend_embeds": torch.from_numpy(rng.normal(
                size=(8, cfg.frontend_tokens, cfg.d_model)).astype(
                    np.float32))}
        params, state, _ = step(params, state, batch)
        leaves, paths = tree_flatten(ref_params)
        live = [x.detach().requires_grad_() for x in leaves]
        loss = loss_fn(tree_unflatten(paths, live), batch, cfg)[0]
        grads = tree_unflatten(paths, torch.autograd.grad(loss, live))
        ref_params, ref_vel = msgd_step(ref_params, ref_vel, grads, lr=0.1,
                                        momentum=0.7)
    for a, b in zip(tree_flatten(params)[0], tree_flatten(ref_params)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)


def test_loss_decreases_over_allgather_steps():
    """The reference's rule: the reduced chatglm3 trains with the sparse
    exchange and the mean of the last five losses is 0.3 below the first
    five's."""
    cfg = get_arch("chatglm3-6b").reduced()
    ex_cfg = ExchangeConfig(mode="allgather", density=0.1, momentum=0.9)
    step = build_train_step(cfg, LaneMesh(4, "cpu"), ex_cfg, lr=0.2,
                            remat=False)
    params = init_params(cfg, seed=0, device="cpu")
    state = step.init_state(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=64, batch_size=8,
                         seed=0, device="cpu")
    losses = []
    for i in range(30):
        params, state, loss = step(params, state, stream.batch(i))
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_remat_gives_the_same_gradients():
    cfg = dataclasses.replace(get_arch("chatglm3-6b").reduced(),
                              compute_dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))}
    grads = {}
    for remat in (False, True):
        step = build_train_step(cfg, LaneMesh(2, "cpu"),
                                ExchangeConfig(mode="dense"), remat=remat)
        grads[remat] = tree_flatten(step.grads(params, batch)[0])[0]
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def _launch(cmd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return re.findall(r"step +\d+ loss=[0-9.]+", proc.stdout + proc.stderr)


FLAGS = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32"]


def test_launcher_runs_on_lanes():
    lines = _launch([sys.executable, "-m", "repro_torch.launch.train",
                     "--devices", "4"] + FLAGS)
    assert len(lines) == 3, lines


def test_launcher_runs_the_moe_family():
    """``--arch qwen3-moe-235b-a22b``: the reduced MoE trains on four lanes
    with finite losses."""
    lines = _launch([sys.executable, "-m", "repro_torch.launch.train",
                     "--arch", "qwen3-moe-235b-a22b", "--devices", "4"]
                    + FLAGS)
    assert len(lines) == 3, lines
    assert all(np.isfinite(float(x.split("=")[1])) for x in lines), lines


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-780m",
                                  "zamba2-2.7b"])
def test_launcher_runs_the_mla_ssm_and_hybrid_families(arch):
    """``--arch``: the reduced MLA, Mamba2 and hybrid families train on
    four lanes with finite losses."""
    lines = _launch([sys.executable, "-m", "repro_torch.launch.train",
                     "--arch", arch, "--devices", "4"] + FLAGS)
    assert len(lines) == 3, lines
    assert all(np.isfinite(float(x.split("=")[1])) for x in lines), lines


def test_launcher_refuses_the_modality_families():
    """The modality families train on four lanes with seeded frontend
    embeddings and finite losses."""
    for arch in ("qwen2-vl-7b", "musicgen-large"):
        lines = _launch([sys.executable, "-m", "repro_torch.launch.train",
                         "--arch", arch, "--devices", "4"] + FLAGS)
        assert len(lines) == 3, (arch, lines)
        losses = [float(x.split("=")[1]) for x in lines]
        assert all(np.isfinite(losses)), (arch, lines)


@pytest.mark.parametrize("mode", ["shardedps"])
def test_launcher_under_torchrun_equals_lanes(mode):
    """Two processes (gloo) print the losses of two lanes of one (every
    mode's exchange over ranks is held to the lanes in
    tests/test_torch_distributed.py)."""
    lanes = _launch([sys.executable, "-m", "repro_torch.launch.train",
                     "--devices", "2", "--mode", mode] + FLAGS)
    ranks = _launch([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc-per-node", "2",
                     "-m", "repro_torch.launch.train", "--mode", mode]
                    + FLAGS)
    assert len(lanes) == 3 and ranks == lanes, (ranks, lanes)
