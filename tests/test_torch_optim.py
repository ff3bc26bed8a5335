"""The port's optimizers, learning-rate schedules and ``SequenceCopyTask``
on the CPU, against the JAX reference's.

* SGD and momentum (plain and Nesterov) bit for bit over 5 steps against
  the reference under ``jax.jit`` (where XLA fuses ``m * u + g`` and
  ``p - lr * u`` into fused multiply-adds), parameters and velocities;
* AdamW with and without weight decay over 5 steps: its float32 moments
  bit for bit (the same fused multiply-adds), the parameters to rtol 1e-6
  / atol 1e-8 (XLA's division and square root round otherwise: a few
  ulps of the step, which weight decay's cancellation leaves beside a
  parameter near 0);
* ``step_decay_lr`` and the warm-up of ``cosine_lr`` exactly; the cosine
  itself to rtol 3e-7 / atol 2**-22 * base_lr: the reference evaluates it
  in float32 (XLA's float32 cosine, then four float32 roundings, 1.4e-7
  of ``base_lr`` at most on these schedules), the port in float64;
* ``SequenceCopyTask``: the reference's ``test_copy_task_shapes``
  assertions, the marker, blank and -1 target columns, payloads in [2,
  vocab), and batches deterministic by (seed, step, worker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SequenceCopyTask as JCopy
from repro.optim import optimizers as jopt
from repro_torch.core.paramspace import tree_flatten
from repro_torch.data.synthetic import SequenceCopyTask as TCopy
from repro_torch.optim import optimizers as topt

SHAPES = {"embed": {"table": (33, 8)}, "units": {"w": (3, 8, 16),
                                                  "b": (3, 16)},
          "final": (8,)}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree))


def _equal_bits(jtree, ttree, what):
    want = jax.tree.leaves(jtree)
    got, paths = tree_flatten(ttree)
    assert len(got) == len(want)
    for path, a, b in zip(paths, got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32),
                                      err_msg=f"{what} {path}")


def _close(jtree, ttree, what, rtol=1e-6, atol=1e-8):
    for path, a, b in zip(tree_flatten(ttree)[1], tree_flatten(ttree)[0],
                          jax.tree.leaves(jtree)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_bit_equal_over_5_steps(nesterov):
    rng = np.random.default_rng(1)
    jp, tp = _both(_tree(rng))
    js, ts = jopt.momentum_init(jp), topt.momentum_init(tp)
    step = jax.jit(lambda p, g, s: jopt.momentum_update(
        p, g, s, lr=0.05, momentum=0.9, nesterov=nesterov))
    for i in range(5):
        jg, tg = _both(_tree(rng))
        jp, js = step(jp, jg, js)
        tp, ts = topt.momentum_update(tp, tg, ts, lr=0.05, momentum=0.9,
                                      nesterov=nesterov)
        _equal_bits(jp, tp, f"step {i} params")
        _equal_bits(js.velocity, ts.velocity, f"step {i} velocity")


def test_sgd_bit_equal_over_5_steps():
    rng = np.random.default_rng(2)
    jp, tp = _both(_tree(rng))
    start = [x.clone() for x in tree_flatten(tp)[0]]
    step = jax.jit(lambda p, g: jopt.sgd_update(p, g, lr=0.1))
    for i in range(5):
        jg, tg = _both(_tree(rng))
        jp = step(jp, jg)
        tp = topt.sgd_update(tp, tg, lr=0.1)
        _equal_bits(jp, tp, f"step {i}")
    # the updates return new trees: the inputs are untouched
    assert not any(torch.equal(a, b)
                   for a, b in zip(start, tree_flatten(tp)[0]))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_over_5_steps(weight_decay):
    rng = np.random.default_rng(3)
    jp, tp = _both(_tree(rng))
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    step = jax.jit(lambda p, g, s: jopt.adamw_update(
        p, g, s, lr=1e-2, weight_decay=weight_decay))
    for i in range(5):
        jg, tg = _both(_tree(rng, scale=0.3))
        jp, js = step(jp, jg, js)
        tp, ts = topt.adamw_update(tp, tg, ts, lr=1e-2,
                                   weight_decay=weight_decay)
        _close(jp, tp, f"step {i} params")
        _equal_bits(js.mu, ts.mu, f"step {i} mu")
        _equal_bits(js.nu, ts.nu, f"step {i} nu")
        assert ts.count == int(js.count) == i + 1
    assert all(m.dtype == torch.float32 for m in tree_flatten(ts.mu)[0])


def test_momentum_and_adamw_keep_the_tree():
    rng = np.random.default_rng(4)
    _, tp = _both(_tree(rng))
    paths = tree_flatten(tp)[1]
    state = topt.momentum_init(tp)
    assert tree_flatten(state.velocity)[1] == paths
    assert not any(bool(v.any()) for v in tree_flatten(state.velocity)[0])
    new, _ = topt.adamw_update(tp, tp, topt.adamw_init(tp), lr=1e-3)
    assert tree_flatten(new)[1] == paths


@pytest.mark.parametrize("total", [100, 50, 7])
def test_step_decay_lr_equals_reference(total):
    want = jopt.step_decay_lr(0.1, total_steps=total)
    got = topt.step_decay_lr(0.1, total_steps=total)
    for s in range(total + 5):
        assert got(s) == want(s), s
    assert got(0) == 0.1 and got(total) == pytest.approx(0.1 * 0.1 * 0.1)


@pytest.mark.parametrize("base_lr,warmup,total,min_frac",
                         [(0.1, 100, 1000, 0.1), (0.05, 10, 300, 0.2),
                          (1.0, 0, 500, 0.05)])
def test_cosine_lr_equals_reference(base_lr, warmup, total, min_frac):
    want = jopt.cosine_lr(base_lr, warmup=warmup, total_steps=total,
                          min_frac=min_frac)
    got = topt.cosine_lr(base_lr, warmup=warmup, total_steps=total,
                         min_frac=min_frac)
    for s in range(total + 10):
        if s < warmup:
            assert got(s) == want(s), s
        else:
            np.testing.assert_allclose(got(s), float(want(s)), rtol=3e-7,
                                       atol=2**-22 * base_lr,
                                       err_msg=f"step {s}")
    assert got(total + 5) == pytest.approx(min_frac * base_lr, rel=1e-12)


def test_copy_task_shapes():
    """The reference's assertions, and its layout column by column."""
    t = TCopy(copy_len=4, delay=3, batch_size=2, device="cpu")
    assert t.seq_len == JCopy(copy_len=4, delay=3, batch_size=2).seq_len
    x, y = t.batch(0)
    assert x.shape == y.shape == (2, t.seq_len) == (2, 1 + 2 * 4 + 3)
    assert x.dtype == y.dtype == torch.int32
    np.testing.assert_array_equal(y[:, -4:].numpy(), x[:, 1:5].numpy())
    assert (x[:, 0] == 1).all()                        # the marker
    assert (x[:, 5:] == 0).all()                       # blanks, answer slots
    assert (y[:, :8] == -1).all()                      # ignored targets
    payload = x[:, 1:5]
    assert int(payload.min()) >= 2 and int(payload.max()) < t.vocab_size
    jx, jy = JCopy(copy_len=4, delay=3, batch_size=2).batch(0)
    # the same layout as the reference's (its payload is its own draw)
    np.testing.assert_array_equal(np.asarray(jx)[:, 0], x[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(jx)[:, 5:], x[:, 5:].numpy())
    np.testing.assert_array_equal(np.asarray(jy)[:, :8], y[:, :8].numpy())


def test_copy_task_deterministic_by_seed_step_and_worker():
    t = TCopy(vocab_size=50, copy_len=6, delay=2, batch_size=64, seed=3,
              device="cpu")
    x, y = t.batch(5, worker=2)
    x2, y2 = t.batch(5, worker=2)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    for other in (t.batch(6, worker=2), t.batch(5, worker=1),
                  TCopy(vocab_size=50, copy_len=6, delay=2, batch_size=64,
                        seed=4, device="cpu").batch(5, worker=2)):
        assert not torch.equal(other[0], x)
    counts = np.bincount(x[:, 1:7].numpy().ravel(), minlength=50)
    assert counts[:2].sum() == 0 and (counts[2:] > 0).all()


def test_copy_task_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TCopy()
