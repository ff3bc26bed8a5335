"""The port's shard index math, sharded wire frames, route exchange and
mesh server stages on the CPU, against the JAX reference's.

Inputs are made with numpy from a seed and fed to both packages; every
comparison is bit for bit (as bit patterns where a value may be -0.0).
The reference's blockwise selection runs its Pallas kernels in interpret
mode, as its own tests run them on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import wire as jwire
from repro.core import async_sim as jsim
from repro.core import distributed as jdist
from repro.core import server as jps
from repro.core.engine import CompressionSpec as JSpec
from repro.core.paramspace import ParamSpace as JSpace
from repro.core.paramspace import ShardSpec as JShard
from repro.core.sparsify import SparseLeaf as JLeaf
from repro.kernels import ops as jops
from repro_torch.cluster import wire as twire
from repro_torch.convert import params_from_numpy
from repro_torch.core import async_sim as tsim
from repro_torch.core import distributed as tdist
from repro_torch.core import server as tps
from repro_torch.core.engine import CompressionSpec as TSpec
from repro_torch.core.paramspace import ParamSpace as TSpace
from repro_torch.core.paramspace import ShardSpec as TShard
from repro_torch.core.sparsify import SparseLeaf as TLeaf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import scatter_apply

MODES = ("none", "bf16", "int8", "tern")
TERN_RTOL = 1e-5   # a tern scale's float32 sum: XLA reorders long sums
# the reference's route and exchange, jitted: one compile a shape instead
# of one a primitive (integer slot math and adds into zeros: the same bits)
jroute = jax.jit(jops.route_by_shard_batch,
                 static_argnames=("bounds", "n_shards", "cap"))
jexchange = jax.jit(jdist.shard_exchange_batch, static_argnums=(0,),
                    static_argnames=("use_mesh",))


def _tree(seed: int, n_leaves: int):
    """A numpy parameter tree of varied ranks and shapes (sorted keys)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(n_leaves):
        shape = tuple(int(rng.integers(1, 7))
                      for _ in range(int(rng.integers(0, 4))))
        tree[f"p{i:02d}"] = rng.normal(size=shape).astype(np.float32)
    return tree


def _spaces(tree):
    """(reference ParamSpace, port ParamSpace) of one numpy tree."""
    return (JSpace.from_tree({k: jnp.asarray(v) for k, v in tree.items()}),
            TSpace.from_tree(params_from_numpy(tree, "cpu")))


def _bits(x):
    """A float32 array's bit pattern (-0 and +0 differ)."""
    return np.asarray(x, np.float32).view(np.int32)


def _same(port, ref):
    """Bit equality of a port tensor and a reference array."""
    a, b = port.numpy(), np.asarray(ref)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a, b)


def _message(space_total, seg, seed):
    """One global-index arena message in both packages: per-segment
    sorted unique indices inside each leaf's range, values with +-0."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=sum(seg)).astype(np.float32)
    vals[::5] = -0.0
    vals[2::7] = 0.0
    idx = rng.permutation(space_total)[:sum(seg)].astype(np.int32)
    return vals, idx


# ------------------------------------------------------------ ShardSpec

@pytest.mark.parametrize("seed", range(12))
def test_shard_spec_bounds_match_reference(seed):
    """for_space's greedy leaf-edge snap, even, sizes and owner_of equal
    the reference's for random leaf lists, S in 1-6 (empty shards too)."""
    rng = np.random.default_rng(seed)
    tree = _tree(seed, int(rng.integers(1, 9)))
    jspace, tspace = _spaces(tree)
    assert (tspace.sizes, tspace.offsets) == (jspace.sizes, jspace.offsets)
    probe = np.arange(-1, tspace.total + 1)
    for S in range(1, 7):
        j, t = JShard.for_space(jspace, S), TShard.for_space(tspace, S)
        assert (t.bounds, t.leaf_splits) == (j.bounds, j.leaf_splits)
        assert (t.n_shards, t.total, t.sizes) == (j.n_shards, j.total,
                                                  j.sizes)
        np.testing.assert_array_equal(t.owner_of(probe), j.owner_of(probe))
        for s in range(S):
            assert t.shard_seg(tspace.ks(0.3), s) == \
                j.shard_seg(jspace.ks(0.3), s)
            assert [tuple(x.shape) for x in t.shard_leaves(
                list(params_from_numpy(tree, "cpu").values()), s)] == \
                [tuple(x.shape) for x in j.shard_leaves(
                    list(tree.values()), s)]
        je, te = JShard.even(tspace.total, S), TShard.even(tspace.total, S)
        assert te.bounds == je.bounds
        assert TShard.even_stride(tspace.total, S) == \
            JShard.even_stride(tspace.total, S)


def test_more_shards_than_leaves_gives_empty_shards():
    tree = {"b": np.ones(3, np.float32), "w": np.ones((5, 2), np.float32)}
    jspace, tspace = _spaces(tree)
    t = TShard.for_space(tspace, 5)
    assert t.bounds == JShard.for_space(jspace, 5).bounds
    assert t.sizes.count(0) >= 3
    params = params_from_numpy(tree, "cpu")
    subs = [t.shard_tree(params, s) for s in range(5)]
    assert [TSpace.from_tree(p).total for p in subs] == list(t.sizes)
    assert [p for p in subs if not p] and all(
        isinstance(p, dict) for p in subs)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("aligned", [True, False])
def test_split_by_shard_and_merge_match_reference(seed, aligned):
    """split_by_shard's pieces and segment tables, and merge, equal the
    reference's: leaf-aligned bounds (static slices) and arbitrary bounds
    inside segments (the host partition), empty shards included."""
    rng = np.random.default_rng(100 + seed)
    tree = _tree(seed, int(rng.integers(1, 7)))
    jspace, tspace = _spaces(tree)
    S = int(rng.integers(1, 7))
    if aligned:
        jspec, tspec = JShard.for_space(jspace, S), TShard.for_space(tspace,
                                                                     S)
    else:
        inner = np.sort(rng.integers(0, tspace.total + 1, size=S - 1))
        bounds = (0, *(int(b) for b in inner), tspace.total)
        jspec, tspec = JShard(bounds=bounds), TShard(bounds=bounds)
    seg = tspace.ks(0.4)
    vals, idx = _message(tspace.total, seg, seed)
    jmsg = JLeaf(jnp.asarray(vals), jnp.asarray(idx), jspace.total)
    tmsg = TLeaf(torch.from_numpy(vals), torch.from_numpy(idx), tspace.total)
    jp, tp = jspec.split_by_shard(jmsg, seg), tspec.split_by_shard(tmsg, seg)
    assert len(tp) == len(jp) == S
    for (t, tseg), (j, jseg) in zip(tp, jp):
        assert tseg == jseg and t.size == j.size
        _same(t.values, j.values)
        _same(t.indices, j.indices)
    tm, jm = tspec.merge([p for p, _ in tp]), jspec.merge([p for p, _ in jp])
    assert tm.size == jm.size == tspace.total
    _same(tm.values, jm.values)
    _same(tm.indices, jm.indices)
    x = rng.normal(size=tspace.total).astype(np.float32)
    for t, j in zip(tspec.split_dense(torch.from_numpy(x)),
                    jspec.split_dense(jnp.asarray(x))):
        _same(t, j)
    _same(tspec.merge([p for p, _ in tspec.split_by_shard(
        torch.from_numpy(x))]), x)


def test_split_refuses_a_wrong_arena_or_missing_seg():
    tspace = TSpace.from_tree(params_from_numpy(
        {"w": np.ones((4, 3), np.float32)}, "cpu"))
    msg = TLeaf(torch.ones(3), torch.arange(3, dtype=torch.int32), 12)
    with pytest.raises(ValueError):
        TShard(bounds=(0, 5)).split_by_shard(msg, (3,))
    with pytest.raises(ValueError):
        TShard.for_space(tspace, 2).split_by_shard(msg)
    with pytest.raises(ValueError):
        TShard(bounds=(0, 3, 2))


# ------------------------------------------------------------ wire frames

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ["exact", "blockwise"])
def test_sharded_frames_equal_reference(engine, mode):
    """encode_sharded_message's payloads equal the reference's byte for
    byte, their sizes shard_frame_bytes_static's (narrower indices on small
    shards, a header-only frame on an empty one), and the merged shipped
    pieces equal the single frame's shipped leaf.  A tern scale is a
    float32 sum that XLA reorders beyond about 20 entries: there the
    scales agree to 1e-5 relative and every other byte is equal."""
    tree = _tree(7, 5)
    jspace, tspace = _spaces(tree)
    seg = tspace.ks(0.4)
    x = np.random.default_rng(9).normal(size=tspace.total).astype(np.float32)
    jmsg = jspace.select(jnp.asarray(x), seg, JSpec(engine=engine))
    tmsg = tspace.select(torch.from_numpy(x), seg, TSpec(engine=engine))
    _same(tmsg.values, jmsg.values)
    _same(tmsg.indices, jmsg.indices)
    _, single = twire.encode_message(twire.UP, 1, 0, [tmsg], mode=mode,
                                     seg=seg)
    for S in (1, 2, 3, 5, 8):
        jspec, tspec = JShard.for_space(jspace, S), TShard.for_space(tspace,
                                                                     S)
        static = twire.shard_frame_bytes_static(tspec, seg, mode)
        assert static == jwire.shard_frame_bytes_static(jspec, seg, mode)
        tframes = twire.encode_sharded_message(
            twire.UP, 1, 0, tmsg, shard_spec=tspec, mode=mode, seg=seg,
            aux=0.5)
        jframes = jwire.encode_sharded_message(
            jwire.UP, 1, 0, jmsg, shard_spec=jspec, mode=mode, seg=seg,
            aux=0.5)
        assert len(tframes) == S
        for s, ((tpay, tship), (jpay, _), nbytes, size) in enumerate(zip(
                tframes, jframes, static, tspec.sizes)):
            assert len(tpay) == len(jpay) == nbytes
            if mode == "tern":
                n_seg = len(tspec.shard_seg(seg, s))
                a = jwire.ENVELOPE_BYTES + 4 + 12 + 4 * n_seg
                b = a + 4 * n_seg
                np.testing.assert_allclose(
                    np.frombuffer(tpay[a:b], np.float32),
                    np.frombuffer(jpay[a:b], np.float32), rtol=TERN_RTOL)
                assert tpay[:a] + tpay[b:] == jpay[:a] + jpay[b:]
            else:
                assert tpay == jpay
            leaf = twire.decode_message(tpay, device="cpu").leaves[0]
            assert leaf.size == size
            _same(leaf.values, tship[0].values.numpy())
        merged = tspec.merge([ship[0] for _, ship in tframes])
        _same(merged.values, single[0].values.numpy())
        _same(merged.indices, single[0].indices.numpy())


# ------------------------------------------------------------ the route

def _route_case(seed: int, total: int, S: int, k: int, B: int):
    """Ragged bounds with duplicates (empty shards), -1 padding, +-0 and
    repeated indices, in both packages' form."""
    rng = np.random.default_rng(seed)
    inner = np.sort(rng.integers(0, total + 1, size=S - 1))
    inner[len(inner) // 2:len(inner) // 2 + 1] = inner[len(inner) // 2 - 1] \
        if len(inner) > 1 else inner[:1]
    bounds = (0, *(int(b) for b in np.sort(inner)), total)
    idx = rng.integers(0, total, size=(B, k)).astype(np.int32)
    idx[rng.random((B, k)) < 0.2] = -1
    vals = rng.integers(-8, 9, size=(B, k)).astype(np.float32)
    vals[:, ::4] = -0.0
    return bounds, idx, vals


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", ["k", "tight"])
def test_route_by_shard_batch_equals_reference(seed, cap):
    """(ri, rv, overflow) of the batched route equal the reference's bit
    for bit, with -1 padding, +-0 (a routed -0 comes out +0: the values are
    added into zeros), duplicate bounds and, with a tight cap, overflow;
    the single-message route is its first lane.  S is 1 to 6."""
    total, S, k, B = 40, seed + 1, 16, 3
    bounds, idx, vals = _route_case(seed, total, S, k, B)
    c = k if cap == "k" else 3
    tri, trv, tovf = tops.route_by_shard_batch(
        torch.from_numpy(idx), torch.from_numpy(vals), bounds=bounds,
        n_shards=S, cap=c)
    jri, jrv, jovf = jroute(
        jnp.asarray(idx), jnp.asarray(vals), bounds=bounds, n_shards=S,
        cap=c)
    _same(tri, jri)
    _same(trv, jrv)
    assert int(tovf) == int(jovf)
    if cap == "k":
        assert int(tovf) == 0
    assert not (_bits(trv.numpy()) == _bits(-0.0)).any()
    ri1, rv1, ovf1 = tops.route_by_shard(
        torch.from_numpy(idx[0]), torch.from_numpy(vals[0]), bounds=bounds,
        n_shards=S, cap=c)
    _same(ri1, jri[0])
    _same(rv1, jrv[0])


@pytest.mark.parametrize("S", range(1, 7))
def test_shard_exchange_batch_equals_reference(S):
    """The route exchange equals the reference's single-device leg
    (``use_mesh=False``), which the reference pins to its collective."""
    rng = np.random.default_rng(50 + S)
    tree = _tree(5, 4)
    jspace, tspace = _spaces(tree)
    jspec, tspec = JShard.for_space(jspace, S), TShard.for_space(tspace, S)
    B, k = 3, 13
    idx = np.stack([rng.permutation(tspace.total)[:k]
                    for _ in range(B)]).astype(np.int32)
    idx[rng.random((B, k)) < 0.15] = -1
    vals = rng.normal(size=(B, k)).astype(np.float32)
    vals[:, 1::3] = -0.0
    got = tdist.shard_exchange_batch(tspec, torch.from_numpy(idx),
                                     torch.from_numpy(vals))
    want = jexchange(jspec, jnp.asarray(idx),
                                      jnp.asarray(vals), use_mesh=False)
    for g, w in zip(got[:2], want[:2]):
        _same(g, w)
    assert int(got[2]) == int(want[2]) == 0


def test_use_mesh_raises():
    """The per-rank leg needs the ranks' ProcessMesh (tests/
    test_torch_distributed.py runs it over gloo)."""
    spec = TShard(bounds=(0, 4, 8))
    with pytest.raises(ValueError, match="ProcessMesh"):
        tdist.shard_exchange_batch(spec, torch.zeros((1, 2), dtype=torch.int32),
                                   torch.zeros((1, 2)), use_mesh=True)


def test_row_scatter_drops_empty_slots():
    """The mesh stages hand the route's -1 slots to the multi-row
    scatter-add as they are: its plain version drops every index outside
    [0, width), so no dump column is needed."""
    dense = torch.from_numpy(np.arange(12, dtype=np.float32).reshape(3, 4))
    idx = torch.tensor([[-1, 2, -1], [3, -1, 4]], dtype=torch.int32)
    vals = torch.tensor([[5.0, 1.0, 7.0], [2.0, 9.0, 3.0]])
    out = scatter_apply.scatter_add_rows_(dense.clone(), [2, 0], idx, vals)
    want = dense.clone()
    want[2, 2] += 1.0
    want[0, 3] += 2.0
    _same(out, want.numpy())


# ------------------------------------------------------------ mesh state

def _mesh_pair(tree, n_workers, S, seed):
    """The same mesh server state in both packages, M and v random (+-0
    planted, padding columns zero)."""
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    tparams = params_from_numpy(tree, "cpu")
    jst = jps.init_mesh_shards(jparams, n_workers, S)
    tst = tps.init_mesh_shards(tparams, n_workers, S)
    rng = np.random.default_rng(seed)
    spec = tst.spec
    M = rng.normal(size=(S, tst.M.shape[1])).astype(np.float32)
    v = rng.normal(size=(n_workers,) + M.shape).astype(np.float32)
    M.reshape(-1)[::9] = -0.0
    for s, sz in enumerate(spec.sizes):
        M[s, sz:] = 0.0
        v[:, s, sz:] = 0.0
    return (jst._replace(M=jnp.asarray(M), v=jnp.asarray(v)),
            tst._replace(M=torch.from_numpy(M.copy()),
                         v=torch.from_numpy(v.copy())))


@pytest.mark.parametrize("S", [1, 2, 4, 6])
def test_mesh_state_matches_reference(S):
    """init_mesh_shards equals the reference's stacked arrays; mesh_split
    and mesh_concat round-trip the arena; init_shards and
    global_model_shards equal the reference's; global_model takes a mesh
    state."""
    tree = _tree(3, 4)
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    tparams = params_from_numpy(tree, "cpu")
    jst = jps.init_mesh_shards(jparams, 5, S)
    tst = tps.init_mesh_shards(tparams, 5, S)
    _same(tst.M, jst.M)
    _same(tst.v, jst.v)
    assert (tst.t, int(tst.overflow)) == (int(jst.t), int(jst.overflow))
    assert tst.spec.bounds == jst.spec.bounds
    assert tps.mesh_width(tst.spec) == jps.mesh_width(jst.spec)
    x = np.random.default_rng(S).normal(size=tst.space.total).astype(
        np.float32)
    tm = tps.mesh_split(tst.spec, torch.from_numpy(x))
    _same(tm, jps.mesh_split(jst.spec, jnp.asarray(x)))
    _same(tps.mesh_concat(tst.spec, tm), x)
    jst2, tst2 = _mesh_pair(tree, 5, S, S)
    _same(tps.mesh_arena(tst2), jps.mesh_arena(jst2))
    jg = jps.global_model(jparams, jst2)
    tg = tps.global_model(tparams, tst2)
    for key in tree:
        _same(tg[key], jg[key])
    jspec, jstates = jps.init_shards(jparams, 3, S)
    tspec, tstates = tps.init_shards(tparams, 3, S)
    assert tspec.bounds == jspec.bounds
    M = np.random.default_rng(S + 1).normal(size=tst.space.total).astype(
        np.float32)
    parts_t = [st._replace(M=torch.from_numpy(M[a:b].copy()))
               for st, a, b in zip(tstates, tspec.bounds, tspec.bounds[1:])]
    parts_j = [st._replace(M=jnp.asarray(M[a:b]))
               for st, a, b in zip(jstates, jspec.bounds, jspec.bounds[1:])]
    for t, j in zip(parts_t, parts_j):
        assert tuple(t.v.shape) == tuple(j.v.shape)
    tg = tps.global_model_shards(tparams, parts_t)
    jg = jps.global_model_shards(jparams, parts_j)
    for key in tree:
        _same(tg[key], jg[key])


def test_mesh_add_and_reset_worker():
    tree = _tree(4, 3)
    jst, tst = _mesh_pair(tree, 3, 4, 0)
    jst, jid = jps.add_worker(jst)
    tst, tid = tps.add_worker(tst)
    assert tid == jid == 3
    jst = jps.reset_worker(jst, 1)
    tst = tps.reset_worker(tst, 1)
    _same(tst.v, jst.v)


# ------------------------------------------------------------ mesh stages

_STAGES = [  # (sparse up, secondary density, engine of the down select)
    (True, 0.3, "exact"),
    (True, 0.3, "blockwise"),
    (True, None, "exact"),
    (False, None, "exact"),
]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("sparse_up,sd,engine", _STAGES)
def test_mesh_stages_equal_reference(sparse_up, sd, engine, S):
    """The mesh server stage and the mesh commit (sparse and dense down)
    give the reference's M, v, downward batch and M_rows bit for bit, on
    the same state and batch (+-0 planted in M and the messages)."""
    tree = _tree(11, 5)
    n_workers, B = 6, 3
    jst, tst = _mesh_pair(tree, n_workers, S, 7 + S)
    space = tst.space
    ids = [4, 0, 2]
    rng = np.random.default_rng(S)
    if sparse_up:
        seg = space.ks(0.4)
        pairs = [_message(space.total, seg, 20 + b) for b in range(B)]
        vals = np.stack([p[0] for p in pairs])
        idx = np.stack([p[1] for p in pairs])
        jmsgs = JLeaf(jnp.asarray(vals), jnp.asarray(idx), space.total)
        tmsgs = TLeaf(torch.from_numpy(vals), torch.from_numpy(idx),
                      space.total)
    else:
        dense = rng.normal(size=(B, space.total)).astype(np.float32)
        dense[:, ::3] = -0.0
        jmsgs, tmsgs = jnp.asarray(dense), torch.from_numpy(dense)
    jspec, tspec = JSpec(engine=engine, quantize="bf16"), TSpec(
        engine=engine, quantize="bf16")
    jserver = jsim.make_mesh_batched_server_step(sd, jspec)
    tserver = tsim.make_mesh_batched_server_step(sd, tspec)
    jst, jG, jrows = jserver(jst, jmsgs, jnp.asarray(ids, jnp.int32))
    tst, tG, trows = tserver(tst, tmsgs, ids)
    _same(tst.M, jst.M)
    assert tst.t == int(jst.t) and int(tst.overflow) == int(jst.overflow)
    if sd is None:
        _same(tG, jG)
        _same(trows, jrows)
        jst, jnnz = jsim.make_mesh_batched_commit(True)(
            jst, jnp.asarray(ids, jnp.int32), jG, jrows)
        tst, tnnz = tsim.make_mesh_batched_commit(True)(tst, ids, tG, trows)
        np.testing.assert_array_equal(tnnz.numpy(), np.asarray(jnnz))
    else:
        assert trows is None and jrows is None
        _same(tG.values, jG.values)
        _same(tG.indices, jG.indices)
        # commit what a wire quantize shipped: bf16-rounded values
        shipped = tG.values.to(torch.bfloat16).float()
        tG = tG._replace(values=shipped)
        jG = jG._replace(values=jnp.asarray(shipped.numpy()))
        jst = jsim.make_mesh_batched_commit(False)(
            jst, jnp.asarray(ids, jnp.int32), jG)
        tst = tsim.make_mesh_batched_commit(False)(tst, ids, tG)
        assert int(tst.overflow) == int(jst.overflow) == 0
    _same(tst.v, jst.v)
    _same(tst.M, jst.M)
