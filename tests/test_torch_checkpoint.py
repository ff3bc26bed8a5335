"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU, against
the JAX reference's (``repro.checkpoint``).

* Pytree ``.npz`` files load across the packages in both directions, a
  bf16 leaf included, and both refuse a structure or shape mismatch.
* Delta chains: for arena histories built once through the reference's
  select and codec (each engine x each wire mode), the port's writer,
  fed the same arrays as CPU tensors, writes ``base.npy``, ``deltas.bin``
  and ``manifest.json`` byte-equal to the reference writer's; each package
  restores the other's chain ``np.array_equal`` at every truncation point
  and after a compaction in either package.
* The edge cases: a ``-0 -> +0`` flip (not recorded: the same k as the
  reference), a NaN entry (recorded again at every append), empty and
  dense deltas, a torn tail and a size mismatch.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, strategies
from repro import checkpoint as jck
from repro_torch import checkpoint as tck

ENGINES = ("exact", "sampled", "blockwise")
MODES = ("none", "bf16", "int8", "tern")
FILES = ("base.npy", "deltas.bin", "manifest.json")


# ------------------------------------------------------------ pytree .npz

def _trees():
    """The same tree for both packages: nested dicts, a list and a tuple,
    one bf16 leaf."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    h = rng.normal(size=(2, 2)).astype(np.float32)
    s = rng.normal(size=2).astype(np.float32)
    jtree = {"layer": {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)},
             "stack": [jnp.asarray(s), (jnp.asarray(h), jnp.asarray(w[0]))]}
    ttree = {"layer": {"w": torch.from_numpy(w),
                       "b": torch.from_numpy(b).to(torch.bfloat16)},
             "stack": [torch.from_numpy(s),
                       (torch.from_numpy(h), torch.from_numpy(w[0].copy()))]}
    return jtree, ttree


def _leaves_equal(jtree, ttree):
    pairs = [(jtree["layer"]["w"], ttree["layer"]["w"]),
             (jtree["layer"]["b"], ttree["layer"]["b"]),
             (jtree["stack"][0], ttree["stack"][0]),
             (jtree["stack"][1][0], ttree["stack"][1][0]),
             (jtree["stack"][1][1], ttree["stack"][1][1])]
    for j, t in pairs:
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.to(torch.float32).numpy())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pytree_npz_loads_across_packages(tmp_path, writer):
    jtree, ttree = _trees()
    path = str(tmp_path / "ck")
    if writer == "port":
        tck.save_checkpoint(path, ttree, step=7, extra={"run": 1})
    else:
        jck.save_checkpoint(path, jtree, step=7, extra={"run": 1})
    keys = sorted(np.load(path + ".npz").files)
    assert keys == ["layer//b", "layer//w", "stack//[0]", "stack//[1]//[0]",
                    "stack//[1]//[1]"]
    jgot, jmeta = jck.load_checkpoint(path, jtree)
    tgot, tmeta = tck.load_checkpoint(path, ttree)
    assert jmeta == tmeta == {"step": 7, "keys": keys, "extra": {"run": 1}}
    _leaves_equal(jgot, tgot)
    _leaves_equal(jtree, tgot)
    assert isinstance(tgot["stack"][1], tuple)


@pytest.mark.parametrize("load", [jck.load_checkpoint, tck.load_checkpoint],
                         ids=["reference", "port"])
def test_pytree_mismatch_raises(tmp_path, load):
    jtree, ttree = _trees()
    like = jtree if load is jck.load_checkpoint else ttree
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, ttree)
    missing = {**like, "extra": like["stack"][0]}
    with pytest.raises(ValueError, match="structure mismatch"):
        load(path, missing)
    bad = dict(like, layer=dict(like["layer"], w=like["layer"]["w"][:2]))
    with pytest.raises(ValueError, match="shape mismatch"):
        load(path, bad)


# ------------------------------------------------------------ delta chains

def _arena_history(seed: int, n_deltas: int, engine: str, mode: str):
    """A live-arena history: theta_0 plus n sparse committed updates, each
    selected per tensor by the reference's ``engine`` and round-tripped
    through its codec in ``mode`` (``tests/test_delta_checkpoint.py``'s
    construction).  numpy f32 arrays."""
    from repro.cluster import wire
    from repro.core import server as ps
    from repro.core.engine import CompressionSpec
    from repro.core.paramspace import ParamSpace

    rng = np.random.default_rng(seed)
    params0 = {"w": rng.normal(size=(7, 5)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)}
    space = ParamSpace.from_tree(params0)
    spec = CompressionSpec(engine=engine, quantize="none", block_r=2)
    ks = space.ks(0.3)
    arena = np.asarray(space.pack(params0))
    states = [arena.copy()]
    theta = jnp.asarray(arena)
    for t in range(n_deltas):
        g = jnp.asarray(rng.normal(size=arena.shape).astype(np.float32)
                        * rng.integers(0, 2, size=arena.shape))
        leaf = space.select(g, ks, spec)
        payload, _ = wire.encode_message(wire.DIFF, 0, t, [leaf],
                                         mode=mode, seg=ks)
        theta = ps.apply_update(theta, wire.decode_message(payload).leaves[0])
        states.append(np.asarray(theta))
    return states


def _write(pkg, path, states, meta=None):
    """One chain of ``states`` through ``pkg``'s writer (the port's fed CPU
    tensors); returns the manifest entries."""
    arr = ((lambda a: a) if pkg is jck
           else (lambda a: torch.from_numpy(np.array(a, np.float32))))
    entries = []
    with pkg.DeltaCheckpointWriter(path, arr(states[0]), version=0,
                                   meta=meta) as w:
        for v, arena in enumerate(states[1:], start=1):
            entries.append(w.append(arr(arena), v))
    return entries


def _restore(pkg, path, **kw):
    if pkg is jck:
        return jck.load_delta_checkpoint(path, **kw)
    arena, version, meta = tck.load_delta_checkpoint(path, device="cpu",
                                                     **kw)
    assert arena.dtype == torch.float32
    return arena.numpy(), version, meta


def _same_files(a, b):
    for name in FILES:
        assert (pathlib.Path(a) / name).read_bytes() == \
            (pathlib.Path(b) / name).read_bytes(), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ENGINES)
@settings(max_examples=4, deadline=None) if HAVE_HYPOTHESIS else \
    (lambda f: f)
@given(strategies.integers(0, 2 ** 31 - 1), strategies.integers(2, 6))
def test_delta_chain_byte_equal_and_cross_restore(engine, mode, seed,
                                                  n_deltas):
    import tempfile

    states = _arena_history(seed, n_deltas, engine, mode)
    meta = {"engine": engine, "mode": mode}
    with tempfile.TemporaryDirectory() as d:
        jdir, tdir = pathlib.Path(d) / "ref", pathlib.Path(d) / "port"
        assert _write(tck, tdir, states, meta) == \
            _write(jck, jdir, states, meta)
        _same_files(jdir, tdir)
        for writer, reader in ((jck, tck), (tck, jck)):
            src = jdir if writer is jck else tdir
            for upto in range(len(states)):
                arena, version, got = _restore(reader, src, upto=upto)
                assert (version, got) == (upto, meta)
                np.testing.assert_array_equal(arena, states[upto])
        # a compaction in either package: the same files, and every later
        # restore point in both packages unchanged
        cut = n_deltas // 2
        jm = jck.compact(jdir, upto=cut)
        tm = tck.compact(tdir, upto=cut, device="cpu")
        assert tm == jm and tm["base_version"] == cut
        _same_files(jdir, tdir)
        for reader in (jck, tck):
            for v in range(cut, n_deltas + 1):
                arena, version, _ = _restore(reader, tdir, upto_version=v)
                assert version == v
                np.testing.assert_array_equal(arena, states[v])


def test_signed_zero_flip_is_not_recorded_and_nan_always_is(tmp_path):
    """IEEE ``!=`` picks the changed set: a -0 -> +0 flip compares equal
    and is skipped (the same k as the reference), a NaN compares unequal
    to itself and is written again at every append."""
    base = np.asarray([1.0, -0.0, 2.0, np.nan], np.float32)
    states = [base,
              np.asarray([1.0, 0.0, 3.0, np.nan], np.float32),
              np.asarray([1.0, 0.0, 3.0, np.nan], np.float32)]
    ref = _write(jck, tmp_path / "ref", states)
    port = _write(tck, tmp_path / "port", states)
    assert port == ref
    assert [e["k"] for e in port] == [2, 1]     # {2, nan}, then {nan}
    _same_files(tmp_path / "ref", tmp_path / "port")
    arena, _, _ = _restore(tck, tmp_path / "ref")
    np.testing.assert_array_equal(arena, states[-1])
    # the restored arena keeps the base's -0: the flip was not recorded
    assert np.signbit(arena[1])


def test_empty_and_dense_deltas(tmp_path):
    """A no-change append is a header-only delta; a whole-arena rewrite
    frames dense and restores as a full assignment."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=64).astype(np.float32)
    states = [base, base.copy(), rng.normal(size=64).astype(np.float32)]
    port = _write(tck, tmp_path / "port", states)
    assert port == _write(jck, tmp_path / "ref", states)
    assert [e["k"] for e in port] == [0, 64]
    _same_files(tmp_path / "ref", tmp_path / "port")
    for upto, want in ((1, base), (2, states[2])):
        arena, version, _ = _restore(tck, tmp_path / "port", upto=upto)
        np.testing.assert_array_equal(arena, want)
        assert version == upto


def test_torn_tail_is_ignored(tmp_path):
    """The manifest is the commit point: bytes appended to the log without
    a manifest entry do not change the restore."""
    rng = np.random.default_rng(1)
    states = [rng.normal(size=16).astype(np.float32) for _ in range(3)]
    _write(tck, tmp_path, states)
    with open(tmp_path / "deltas.bin", "ab") as f:
        f.write(b"\x00garbage-torn-append")
    arena, version, _ = _restore(tck, tmp_path)
    np.testing.assert_array_equal(arena, states[2])
    assert version == 2


def test_size_mismatch_rejected(tmp_path):
    with tck.DeltaCheckpointWriter(tmp_path,
                                   torch.zeros(8, dtype=torch.float32)) as w:
        with pytest.raises(ValueError, match="chain total"):
            w.append(torch.zeros(9, dtype=torch.float32), 1)
