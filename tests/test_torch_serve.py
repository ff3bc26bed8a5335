"""The port's serve leg on the CPU, against the JAX reference's.

* ``SubscriberBook``: one seeded sequence of ``M`` through both packages'
  books gives byte-equal DIFF and SYNC payloads and bit-equal cursors.
* ``run_inprocess`` with replicas: the training run is bit-equal to the
  port's serial ``AsyncTrainer.run`` and to the reference's (losses,
  params, bytes); every replica ends on the final arena bit for bit.
* The ``sub/*`` counters, ``decode_fn``'s advancing models, the
  coordinator's delta-checkpoint chain (byte-equal to the reference
  runner's), a replica over TCP, what still raises, the serve
  launcher's ``--smoke`` on the CPU, and its ``--role decode`` against a
  direct prefill/decode loop (every family, the modality ones with their
  seeded frontend embeddings) and, for qwen2-vl-7b, against the
  reference's greedy ids from the same weights, prompt and patches.

The grad_fn is elementwise (grads = w - target), so every parameter, ``M``
and ``v`` is bit-equal in the two frameworks, and so is its loss.  Every receive and join is
bounded by ``TIMEOUT``; TCP uses 127.0.0.1 only.
"""
import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import run_inprocess as jrun_inprocess
from repro.cluster import subscribe as jsub
from repro.core import async_sim as jsim
from repro.core import make_strategy as jmake
from repro.core.engine import CompressionSpec as JSpec
from repro.core.paramspace import ParamSpace as JSpace
from repro_torch.checkpoint import load_delta_checkpoint
from repro_torch.cluster import run_inprocess, subscribe as tsub, wire
from repro_torch.cluster.client import ClusterClient
from repro_torch.cluster.coordinator import Coordinator
from repro_torch.cluster.replica import InferenceReplica
from repro_torch.cluster.scenarios import ClientPlan
from repro_torch.cluster.transport import (TcpClientTransport,
                                           TcpCoordinatorTransport)
from repro_torch.convert import params_from_numpy
from repro_torch.core import async_sim as tsim
from repro_torch.core import make_strategy as tmake
from repro_torch.core.engine import CompressionSpec as TSpec
from repro_torch.core.paramspace import ParamSpace as TSpace

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 60.0
N_POOL = 64


def _problem():
    """(params, pool) in numpy: a 6x4 + 4 model and a pool of targets."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)}
    pool = [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()} for _ in range(N_POOL)]
    return params, pool


# the loss is one residual squared: no reduction, so both frameworks round
# it alike and the losses too are bit-equal
def _jax_grad_fn(p, t):
    grads = jax.tree.map(lambda w, x: w - x, p, t)
    return grads["b"][0] ** 2, grads


def _torch_grad_fn(p, t):
    grads = {k: p[k] - t[k] for k in p}
    return grads["b"][0] ** 2, grads


def _both():
    """((params0, batch_fn) of the reference, of the port)."""
    params, pool = _problem()
    jpool = [{k: jnp.asarray(v) for k, v in b.items()} for b in pool]
    tpool = [params_from_numpy(b, "cpu") for b in pool]

    def pick(e, k):
        return (int(e) * 7 + int(k)) % N_POOL

    return (({k: jnp.asarray(v) for k, v in params.items()},
             lambda e, k: jpool[pick(e, k)]),
            (params_from_numpy(params, "cpu"),
             lambda e, k: tpool[pick(e, k)]))


def _arena(params):
    return TSpace.from_tree(params).pack(params)


# ------------------------------------------------------------ the book

@pytest.mark.parametrize("push_density,engine,mode", [
    (0.3, "exact", "none"), (0.3, "blockwise", "int8"),
    (0.3, "exact", "tern"), (None, "exact", "none")])
def test_subscriber_book_payloads_byte_equal(push_density, engine, mode):
    params, _ = _problem()
    jspace = JSpace.from_tree({k: jnp.asarray(v) for k, v in params.items()})
    tspace = TSpace.from_tree(params_from_numpy(params, "cpu"))
    jbook = jsub.SubscriberBook(jspace, push_density=push_density,
                                push_spec=JSpec(engine=engine, quantize=mode))
    tbook = tsub.SubscriberBook(tspace, push_density=push_density,
                                push_spec=TSpec(engine=engine, quantize=mode),
                                device="cpu")
    addrs = [wire.SUBSCRIBER_BASE, wire.SUBSCRIBER_BASE + 1]
    for book in (jbook, tbook):
        for a in addrs:
            book.add(a)
    rng = np.random.default_rng(11)
    M = np.zeros(tspace.total, np.float32)
    for version in range(1, 13):
        M = M + (rng.normal(size=M.shape)
                 * rng.integers(0, 2, size=M.shape)).astype(np.float32)
        for a in addrs:
            if rng.random() < 0.3:      # this replica does not pull now
                continue
            quiesced = version == 12
            jp = jbook.diff_payload(a, jnp.asarray(M), version, quiesced)
            tp = tbook.diff_payload(a, torch.from_numpy(M.copy()), version,
                                    quiesced)
            assert tp == jp, (version, a)
            np.testing.assert_array_equal(
                tbook.subs[a].v.numpy().view(np.uint32),
                np.asarray(jbook.subs[a].v).view(np.uint32))
    for a in addrs:
        assert tbook.sync_payload(a, torch.from_numpy(M.copy()), 12) == \
            jbook.sync_payload(a, jnp.asarray(M), 12)
        for field in ("version", "pushes", "push_bytes", "lag_max",
                      "synced"):
            assert getattr(tbook.subs[a], field) == \
                getattr(jbook.subs[a], field), field
    assert tbook.live() == jbook.live() == addrs


# ------------------------------------------------------------ in process

def _fleet(strat, tp, tbatch, sched, **kw):
    return run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=sched,
                         lr=0.03, secondary_density=0.1, timeout=TIMEOUT,
                         **kw)


@pytest.mark.parametrize("push_density,engine,mode", [
    (0.3, "exact", "none"), (None, "exact", "none"), (0.3, "exact", "int8"),
    (0.3, "blockwise", "tern")])
def test_replicas_bit_exact_and_training_untouched(push_density, engine,
                                                   mode):
    """A fleet attached: the training run is the serial run's, bit for bit
    (the reference's in params and bytes), and every replica ends on the
    final arena."""
    (jp, jbatch), (tp, tbatch) = _both()
    sched = jsim.make_schedule(3, 30, seed=7, hetero=0.9)
    jf, _, jh = jsim.AsyncTrainer(
        jmake("dgs", density=0.2, momentum=0.7), _jax_grad_fn, 3, lr=0.03,
        secondary_density=0.1).run(jp, sched, jbatch)
    strat = tmake("dgs", density=0.2, momentum=0.7)
    sf, _, sh = tsim.AsyncTrainer(strat, _torch_grad_fn, 3, lr=0.03,
                                  secondary_density=0.1,
                                  device="cpu").run(tp, sched, tbatch)
    f, h = _fleet(strat, tp, tbatch, sched, n_replicas=2,
                  push_density=push_density,
                  push_spec=TSpec(engine=engine, quantize=mode),
                  max_staleness=2)

    np.testing.assert_array_equal(h.losses, sh.losses)
    np.testing.assert_array_equal(h.losses, jh.losses)
    assert (h.up_bytes, h.down_bytes) == (sh.up_bytes, sh.down_bytes) == \
        (jh.up_bytes, jh.down_bytes)
    for key in jf:
        np.testing.assert_array_equal(f[key].numpy(), sf[key].numpy())
        np.testing.assert_array_equal(f[key].numpy(), np.asarray(jf[key]))
    final = _arena(f)
    replicas = h.metrics["replicas"]
    assert len(replicas) == 2
    for r in replicas:
        assert torch.equal(r["arena"].view(torch.int32),
                           final.view(torch.int32))
        assert r["version"] == len(h.losses)
        assert r["diffs"] >= 1 and r["bytes_in"] > 0


def test_replica_counters_recorded():
    _, (tp, tbatch) = _both()
    sched = jsim.make_schedule(2, 20, seed=3)
    strat = tmake("dgs", density=0.25, momentum=0.7)
    _, h = _fleet(strat, tp, tbatch, sched, n_replicas=2, push_density=0.25)
    cnt = h.metrics["counters"]
    for i in range(2):
        r = h.metrics["replicas"][i]
        assert cnt[f"sub/{i}/pushes"] == r["diffs"] + 1    # + the SYNC
        assert cnt[f"sub/{i}/push_bytes"] == r["bytes_in"] > 0
        assert f"sub/{i}/lag_max" in cnt
        assert cnt[f"sub/{i}/version"] == len(h.losses)
    assert cnt["sub_joins"] == 2 and cnt["sub_syncs"] == 2


def test_replica_decode_fn_sees_advancing_models():
    """decode_fn runs at every decode boundary, and the models it sees
    move with the training run."""
    _, (tp, tbatch) = _both()
    sched = jsim.make_schedule(2, 24, seed=5)
    strat = tmake("dgs", density=0.25, momentum=0.7)
    seen = []

    def decode_fn(params, step):
        seen.append(float(torch.sum(torch.abs(params["w"] - tp["w"]))))

    _, h = _fleet(strat, tp, tbatch, sched, n_replicas=1, push_density=0.25,
                  replica_decode_fn=decode_fn)
    r = h.metrics["replicas"][0]
    assert r["decodes"] == len(seen) >= 1
    # the diffs move the model off theta_0
    assert seen[-1] > 0 or r["diffs"] <= 1


def test_runner_checkpoint_chain_byte_equal_to_reference(tmp_path):
    (jp, jbatch), (tp, tbatch) = _both()
    sched = jsim.make_schedule(2, 16, seed=9)
    jf, jh = jrun_inprocess(jmake("dgs", density=0.25, momentum=0.7),
                            _jax_grad_fn, jp, jbatch, schedule=sched,
                            lr=0.03, secondary_density=0.1,
                            ckpt_dir=tmp_path / "ref", ckpt_every=5,
                            timeout=TIMEOUT)
    f, h = _fleet(tmake("dgs", density=0.25, momentum=0.7), tp, tbatch,
                  sched, ckpt_dir=tmp_path / "port", ckpt_every=5)
    for name in ("base.npy", "deltas.bin", "manifest.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    arena, version, meta = load_delta_checkpoint(tmp_path / "port",
                                                 device="cpu")
    assert torch.equal(arena, _arena(f))
    assert version == len(h.losses) == 16
    assert meta == {"n_slots": 2, "shard_id": 0}
    assert h.metrics["counters"]["ckpt_deltas"] == \
        jh.metrics["counters"]["ckpt_deltas"] >= 2


# ------------------------------------------------------------ TCP, launcher

def test_tcp_replica_bit_exact():
    """Real sockets: two training clients and a replica, threads of this
    process; the replica's final arena equals the server model bitwise."""
    _, (tp, tbatch) = _both()
    strat = tmake("dgs", density=0.2, momentum=0.7)
    ct = TcpCoordinatorTransport()
    coord = Coordinator(transport=ct, params0=tp, n_slots=2,
                        secondary_density=0.2, recv_timeout=TIMEOUT,
                        push_density=0.3, min_subscribers=1)
    errors, results = [], {}

    def client_main(cid):
        t = TcpClientTransport("127.0.0.1", ct.port, cid)
        try:
            ClusterClient(
                transport=t, strategy=strat, grad_fn=_torch_grad_fn,
                params0=tp, batch_fn=tbatch,
                plan=ClientPlan(client_id=cid, n_rounds=6), lr=0.05,
                recv_timeout=TIMEOUT).run()
        except Exception as exc:
            errors.append(exc)
        finally:
            t.close()

    def replica_main():
        t = TcpClientTransport("127.0.0.1", ct.port, wire.SUBSCRIBER_BASE)
        try:
            results["replica"] = InferenceReplica(
                t, tp, replica_id=0, max_staleness=2,
                recv_timeout=TIMEOUT).run()
        except Exception as exc:
            errors.append(exc)
        finally:
            t.close()

    threads = [threading.Thread(target=client_main, args=(i,), daemon=True)
               for i in range(2)]
    threads.append(threading.Thread(target=replica_main, daemon=True))
    for t in threads:
        t.start()
    try:
        final, hist = coord.serve()
    finally:
        for t in threads:
            t.join(timeout=TIMEOUT)
        ct.close()
    assert not errors, errors
    assert len(hist.losses) == 12
    r = results["replica"]
    assert torch.equal(r.arena, _arena(final))
    assert r.version == 12
    assert hist.metrics["counters"]["sub/0/pushes"] >= 1


def test_sharded_serving_and_decode_role_raise(capsys):
    from repro.models import decode_step as jdecode
    from repro.models import prefill as jprefill
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    _, (tp, tbatch) = _both()
    strat = tmake("dgs", density=0.25)
    for kw in (dict(n_shards=2), dict(mesh_shards=2)):
        with pytest.raises(NotImplementedError, match="later slice"):
            run_inprocess(strat, _torch_grad_fn, tp, tbatch, schedule=[0, 1],
                          n_replicas=1, **kw)
    # the decode role of qwen2-vl (M-RoPE over a patch grid) against the
    # reference: its greedy ids are those of the reference's prefill and
    # decode_step from the same weights, prompt and patch embeddings,
    # wherever the reference's top-2 margin exceeds 5e-2 (bf16 compute;
    # the first disagreement ends a sequence's comparison)
    arch, B, S, n = "qwen2-vl-7b", 3, 20, 8
    got = _decode_role_ids(capsys, arch, B, S, n, 0.0)
    cfg = get_arch(arch).reduced()
    params = jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                          init_params(cfg, seed=0, device="cpu"))
    gen = torch.Generator("cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                     generator=gen).to(cfg.cdtype)
    jcfg = _ref_cfg(arch)
    logits, caches, _ = jprefill(params, jnp.asarray(prompt.numpy()), jcfg,
                                 frontend_embeds=jnp.asarray(
                                     fe.float().numpy()), max_len=S + n)
    step = jax.jit(lambda p, c, t, pos: jdecode(p, c, t, pos, jcfg))
    live = np.ones(B, bool)
    for t in range(n):
        lg = np.asarray(logits[:, -1], np.float32)
        want = lg.argmax(-1)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        differ = live & (want != np.array([row[t] for row in got]))
        assert (top2[differ, 1] - top2[differ, 0] <= 5e-2).all(), (t, got)
        live &= ~differ
        if t == 0:
            assert live.any(), "the first token differs in every sequence"
        tok = np.array([row[t] for row in got], np.int32)[:, None]
        logits, caches = step(params, caches, jnp.asarray(tok),
                              jnp.int32(S + t))


def _ref_cfg(arch):
    from repro.configs import get_arch as jget_arch

    return jget_arch(arch).reduced()


def _decode_role_ids(capsys, arch, B, S, n, temperature):
    """``--role decode --device cpu``'s ``B`` rows of ``n`` ids."""
    from repro_torch.launch import serve

    assert serve.main(["--role", "decode", "--device", "cpu", "--arch", arch,
                       "--batch", str(B), "--prompt-len", str(S), "--gen",
                       str(n), "--temperature", str(temperature)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"[serve] arch={arch}-reduced")
    assert lines[1] == "[serve] generated token ids:"
    assert lines[-1] == "[serve] done"
    rows = [line.split(" ", 4) for line in lines[2:-1]]
    assert [r[:4] for r in rows] == [["", "", "seq", str(b)]
                                     for b in range(B)]
    return [[int(x) for x in r[4].strip("[]").split(",")] for r in rows]


@pytest.mark.parametrize("arch,temperature",
                         [("chatglm3-6b", 0.0), ("gemma3-12b", 0.8),
                          ("dbrx-132b", 0.0), ("minicpm3-4b", 0.0),
                          ("mamba2-780m", 0.8), ("zamba2-2.7b", 0.0),
                          ("qwen2-vl-7b", 0.0), ("musicgen-large", 0.8)])
def test_decode_role_equals_a_direct_loop(arch, temperature, capsys):
    """``--role decode --device cpu`` prints ``--batch`` rows of ``--gen``
    ids: those of a prefill/decode_step loop on the same seeded prompt
    (and, for the modality families, the frontend embeddings drawn next
    from the same generator), greedy or sampled from that generator."""
    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, init_params, prefill

    B, S, n = 3, 20, 6
    got = _decode_role_ids(capsys, arch, B, S, n, temperature)

    cfg = get_arch(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator("cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    fe = None
    if cfg.frontend_tokens:
        fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                         generator=gen).to(cfg.cdtype)

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]
        return logits.argmax(-1)

    logits, caches, _ = prefill(params, prompt, cfg, frontend_embeds=fe,
                                max_len=S + n)
    want = [pick(logits[:, -1])]
    for t in range(n - 1):
        logits, caches = decode_step(params, caches, want[-1][:, None], S + t,
                                     cfg)
        want.append(pick(logits[:, 0]))
    want = torch.stack(want, dim=1)
    assert got == want.tolist()
    assert all(0 <= x < cfg.vocab_size for row in got for x in row)


def test_serve_launcher_smoke_on_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--out-dir", str(tmp_path / "fleet"),
         "--timeout", "60"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "smoke OK" in out
    assert (tmp_path / "fleet" / "ckpt" / "manifest.json").exists()
