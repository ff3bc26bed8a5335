"""The port's serial event loop against the JAX reference's, on the CPU.

Inputs are built once with numpy and fed to both packages.  With an
elementwise grad_fn (grads = w - target) the gradients are bit-equal in both
frameworks, so a whole run must be bit-equal in final params, M, v and wire
bytes; losses are reductions taken in different orders and agree to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_sim as jsim
from repro.core import engine as jengine
from repro.core import make_strategy as jmake
from repro_torch.convert import params_from_numpy
from repro_torch.core import async_sim as tsim
from repro_torch.core import engine as tengine
from repro_torch.core import make_strategy as tmake
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models.mlp import MLP

N_WORKERS, N_EVENTS = 5, 40


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "w1": rng.normal(size=(12, 16)).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": rng.normal(size=(16, 4)).astype(np.float32),
    }
    pool = [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()} for _ in range(N_EVENTS)]
    return params, pool


def _jax_grad_fn(p, t):
    grads = jax.tree.map(lambda w, x: w - x, p, t)
    loss = sum(jnp.mean(g ** 2) for g in jax.tree.leaves(grads))
    return loss, grads


def _torch_grad_fn(p, t):
    grads = {k: p[k] - t[k] for k in p}
    loss = sum(torch.mean(g ** 2) for g in grads.values())
    return loss, grads


def _specs(cls, eng, dq):
    kw = {"block_r": 4} if eng == "blockwise" else {}
    return cls(engine=eng, quantize=dq, **kw)


# (strategy, kwargs, secondary_density, down_quantize, engine): the
# reference's _PARITY_CONFIGS (tests/test_async_sim.py), plus the kernel
# path on the worker (blockwise DGS, int8 up) and GD's DGS twin
_CONFIGS = [
    ("dgs", dict(density=0.1), 0.1, "int8", "exact"),
    ("dgs", dict(density=0.2), 0.15, "bf16", "sampled"),
    ("dgs", dict(density=0.1), 0.1, "tern", "blockwise"),
    ("dgc_async", dict(density=0.1), 0.1, "none", "exact"),
    ("asgd", dict(), None, "none", "exact"),
    ("gd_async", dict(density=0.1), 0.1, "int8", "exact"),
    ("dgs", dict(density=0.1, engine="blockwise", quantize="int8"), 0.1,
     "none", "blockwise"),
    ("dgs_plain", dict(density=0.2, engine="sampled"), None, "none",
     "exact"),
]


@pytest.mark.parametrize("name,kw,sec,dq,eng", _CONFIGS)
def test_run_bit_equal_to_reference(name, kw, sec, dq, eng):
    params, pool = _problem()
    sched = jsim.make_schedule(N_WORKERS, N_EVENTS, seed=3, hetero=0.8)
    lr_fn = lambda e: 0.05 / (1 + 0.01 * e)  # noqa: E731

    jtr = jsim.AsyncTrainer(jmake(name, **kw), _jax_grad_fn, N_WORKERS,
                            lr=0.05, secondary_density=sec,
                            secondary_spec=_specs(jengine.CompressionSpec,
                                                  eng, dq))
    jf, js, jh = jtr.run({k: jnp.asarray(v) for k, v in params.items()},
                         sched, lambda e, k: pool[e], lr_fn=lr_fn)

    ttr = tsim.AsyncTrainer(tmake(name, **kw), _torch_grad_fn, N_WORKERS,
                            lr=0.05, secondary_density=sec,
                            secondary_spec=_specs(tengine.CompressionSpec,
                                                  eng, dq), device="cpu")
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    tf, ts, th = ttr.run(params_from_numpy(params, "cpu"), sched,
                         lambda e, k: tpool[e], lr_fn=lr_fn)

    assert (th.up_bytes, th.down_bytes) == (jh.up_bytes, jh.down_bytes)
    for key in params:
        np.testing.assert_array_equal(tf[key].numpy(), np.asarray(jf[key]))
    np.testing.assert_array_equal(ts.M.numpy(), np.asarray(js.M))
    np.testing.assert_array_equal(ts.v.numpy(), np.asarray(js.v))
    np.testing.assert_allclose(th.losses, jh.losses, rtol=1e-6)
    np.testing.assert_array_equal(th.staleness, jh.staleness)


@pytest.mark.parametrize("n,e,seed,hetero", [(5, 40, 3, 0.8), (8, 600, 1, 0.8),
                                             (100, 96, 7, 0.8), (4, 200, 0, 0.0)])
def test_schedule_and_staleness_equal(n, e, seed, hetero):
    a = jsim.make_schedule(n, e, seed=seed, hetero=hetero)
    b = tsim.make_schedule(n, e, seed=seed, hetero=hetero)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jsim.staleness_of(a, n),
                                  tsim.staleness_of(b, n))


def test_eval_fn_every_matches_reference():
    params, pool = _problem(1)
    sched = jsim.make_schedule(N_WORKERS, N_EVENTS, seed=1, hetero=0.5)
    jtr = jsim.AsyncTrainer(jmake("dgs", density=0.1), _jax_grad_fn,
                            N_WORKERS, lr=0.05, secondary_density=0.1)
    ttr = tsim.AsyncTrainer(tmake("dgs", density=0.1), _torch_grad_fn,
                            N_WORKERS, lr=0.05, secondary_density=0.1,
                            device="cpu")
    _, _, jh = jtr.run({k: jnp.asarray(v) for k, v in params.items()}, sched,
                       lambda e, k: pool[e], eval_every=8,
                       eval_fn=lambda m: float(np.asarray(m["w1"]).sum()))
    tpool = [params_from_numpy(b, "cpu") for b in pool]
    _, _, th = ttr.run(params_from_numpy(params, "cpu"), sched,
                       lambda e, k: tpool[e], eval_every=8,
                       eval_fn=lambda m: float(m["w1"].sum()))
    assert [e for e, _ in th.evals] == [e for e, _ in jh.evals] == \
        [8, 16, 24, 32, 40]
    np.testing.assert_allclose([v for _, v in th.evals],
                               [v for _, v in jh.evals], rtol=1e-5)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        tr = tsim.AsyncTrainer(tmake("asgd"), _torch_grad_fn, 2, lr=0.1)
        assert tr.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsim.AsyncTrainer(tmake("asgd"), _torch_grad_fn, 2, lr=0.1)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsim.AsyncTrainer(tmake("asgd"), _torch_grad_fn, 2, lr=0.1,
                              device="cuda")


@pytest.mark.parametrize("kind", ["MLP", "ClassificationTask"])
def test_model_and_data_follow_the_device_rule(kind):
    """The model and the task default to the card as the trainer does, and
    raise without one; ``device="cpu"`` puts their tensors on the CPU."""
    def make(**kw):
        if kind == "MLP":
            return MLP((4, 3, 2), **kw)
        return ClassificationTask(n_features=4, n_classes=2, batch_size=3,
                                  **kw)

    def devices(obj):
        tensors = obj.params().values() if kind == "MLP" else obj.batch(0)
        return {t.device.type for t in tensors}

    if torch.cuda.is_available():
        assert devices(make()) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert devices(make(device="cpu")) == {"cpu"}


def _quickstart_problem():
    rng = np.random.default_rng(0)
    params = {"w1": (rng.normal(size=(64, 64)) * 0.18).astype(np.float32),
              "b1": np.zeros(64, np.float32),
              "w2": (rng.normal(size=(64, 10)) * 0.18).astype(np.float32),
              "b2": np.zeros(10, np.float32)}
    centers = rng.normal(size=(10, 64))
    pool = []
    for _ in range(60):
        y = rng.integers(0, 10, 32)
        x = (centers[y] + 0.8 * rng.normal(size=(32, 64))).astype(np.float32)
        pool.append((x, y.astype(np.int32)))
    return params, pool


def _jax_mlp_grad(p, batch):
    x, y = batch

    def loss(p):
        h = jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        lp = jax.nn.log_softmax(h)
        return -jnp.mean(lp[jnp.arange(x.shape[0]), y])

    return jax.value_and_grad(loss)(p)


@pytest.mark.parametrize("name,kw", [("asgd", {}),
                                     ("dgs", dict(density=0.01))])
def test_mlp_quickstart_matches_reference(name, kw):
    """The quickstart's MLP (autograd against value_and_grad) for 60
    events.  The matmuls and the softmax reduce in other orders in the two
    frameworks, so gradients differ in the last bits and those differences
    compound over the events: losses agree to 1e-5 relative, parameters to
    1e-5 absolute; dgs's static frames make the bytes exactly equal."""
    params, pool = _quickstart_problem()
    sched = jsim.make_schedule(8, 60, seed=1, hetero=0.8)
    jtr = jsim.AsyncTrainer(jmake(name, **kw), _jax_mlp_grad, 8, lr=0.1)
    jf, _, jh = jtr.run({k: jnp.asarray(v) for k, v in params.items()},
                        sched, lambda e, k: pool[e])
    model = MLP((64, 64, 10), start=1, device="cpu")
    tpool = [(torch.from_numpy(x), torch.from_numpy(y).long())
             for x, y in pool]
    ttr = tsim.AsyncTrainer(tmake(name, **kw), model.grad_fn, 8, lr=0.1,
                            device="cpu")
    tf, _, th = ttr.run(params_from_numpy(params, "cpu"), sched,
                        lambda e, k: tpool[e])
    np.testing.assert_allclose(th.losses, jh.losses, rtol=1e-5)
    for key in params:
        np.testing.assert_allclose(tf[key].numpy(), np.asarray(jf[key]),
                                   atol=1e-5)
    if name == "dgs":
        assert (th.up_bytes, th.down_bytes) == (jh.up_bytes, jh.down_bytes)
