"""The port's wire codec and its kernels' plain versions, on the CPU,
against the JAX reference.

Inputs are made with numpy and fed to both packages.  The reference's
``quantize_pack`` runs both ways its own tests run it on the CPU: through
the Pallas kernels in interpret mode, and through its plain XLA ops.
Codes, indices and every frame byte are bit-equal; a tern scale over more
than about 20 entries is a float32 sum that XLA reorders, and there it
agrees to 1e-5 relative (n * 2**-24 in the worst case for these n).
"""
import os
import sys
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import wire as jwire
from repro.core import sparsify as jsp
from repro.kernels import wire_pack as jwp
from repro_torch.cluster import wire as twire
from repro_torch.core import sparsify as tsp
from repro_torch.core.sparsify import SparseLeaf
from repro_torch.kernels import build, wire_pack as twp

MODES = ("none", "bf16", "int8", "tern")
SHORT, LONG = (4, 9, 20), (100, 30, 126)
TERN_RTOL = 1e-5


def _rng(*words):
    return np.random.default_rng(zlib.crc32(repr(words).encode()))


def _values(k, *words):
    v = _rng(k, *words).normal(size=k).astype(np.float32)
    v[::7] = 0.0                 # zeros: tern's nnz, sign of zero
    v[3::11] = -v[3::11]
    v[5::13] = -0.0
    return v


def _host(codes):
    """Port wire codes as the numpy array the frame serializes."""
    a = codes.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _leaves(k, size, seg, *words):
    """The same arena message in both packages: (port leaf, ref leaf)."""
    rng = _rng(k, size, *words)
    idx = np.sort(rng.choice(size, k, replace=False)).astype(np.int32)
    v = _values(k, size, *words)
    return (SparseLeaf(torch.from_numpy(v), torch.from_numpy(idx), size),
            jsp.SparseLeaf(jnp.asarray(v), jnp.asarray(idx), size))


# ------------------------------------------------------------ kernels 5-6

@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("seg", [SHORT, LONG], ids=["short", "long"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_pack_matches_reference(mode, seg, pallas):
    v = _values(sum(seg), "qp", mode)
    tc, ts, tq = twp.quantize_pack(torch.from_numpy(v), mode=mode, seg=seg)
    jc, js, jq = jwp.quantize_pack(jnp.asarray(v), mode=mode, seg=seg,
                                   pallas=pallas, interpret=pallas)
    np.testing.assert_array_equal(_host(tc), np.asarray(jc))
    assert _host(tc).dtype == np.asarray(jc).dtype
    if mode == "tern" and seg == LONG:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                   rtol=TERN_RTOL)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq),
                                   rtol=TERN_RTOL)
    else:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("mode", ["bf16", "int8", "tern"])
def test_kernel_plain_version_is_the_simulators_quantizer(mode):
    """What the codec ships (the segmented quantize's plain version)
    equals the simulator's quantize_segments bit for bit, sign of zero
    aside: the identity that keeps a cluster run equal to AsyncTrainer."""
    v = torch.from_numpy(_values(256, "sim", mode))
    _, _, shipped = twp.quantize_pack(v, mode=mode, seg=LONG)
    sim = tsp.quantize_segments(v, mode, LONG)
    assert torch.equal(shipped, sim)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 127, 1000, 1001])
def test_tern_pack_plain_matches_codec(k):
    codes = _rng("tp", k).integers(-1, 2, size=k).astype(np.int8)
    packed = twp.tern_pack_plain(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.numel() == (k + 3) // 4
    assert packed.numpy().tobytes() == jwire._pack_tern(codes)
    np.testing.assert_array_equal(
        twire._unpack_tern(packed.numpy().tobytes(), k), codes)


@pytest.mark.parametrize("size", [10, 256, 257, 65536, 65537, 10_512_650])
def test_narrow_indices_widths(size):
    idx = np.unique(_rng("ni", size).integers(0, size, 64)).astype(np.int32)
    idx[-1] = size - 1
    got = twp.narrow_indices(torch.from_numpy(idx), size=size)
    want = np.asarray(jwp.narrow_indices(jnp.asarray(idx), size=size))
    assert got.dtype == want.dtype == twire.index_dtype(size)
    assert got.tobytes() == want.tobytes()


def test_wrappers_take_only_cpu_or_cuda():
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        twp.segment_quantize(meta[None], (8,), "int8")
    with pytest.raises(ValueError, match="no kernel"):
        twp.frame_tail(meta, torch.zeros(8, dtype=torch.int32,
                                         device="meta"), (8,), "tern", 64)
    with pytest.raises(ValueError, match="no kernel"):
        tsp.quantize_rows(meta[None], "tern")
    with pytest.raises(ValueError, match="seg"):
        twp.quantize_pack(torch.ones(8), mode="int8", seg=(3, 4))


# ------------------------------------------------------------ frames

def _split_scales(frame, n_seg, mode):
    """(bytes before the scale block, scales, bytes after) of an ARENA
    frame inside an envelope."""
    start = jwire.ENVELOPE_BYTES + 4 + 12 + 4 * n_seg
    if mode not in ("int8", "tern"):
        return frame, None, b""
    end = start + 4 * n_seg
    return (frame[:start], np.frombuffer(frame[start:end], np.float32),
            frame[end:])


@pytest.mark.parametrize("size", [256, 5000, 70000], ids=["u8", "u16", "u32"])
@pytest.mark.parametrize("seg", [SHORT, LONG], ids=["short", "long"])
@pytest.mark.parametrize("mode", MODES)
def test_arena_frames_byte_identical(mode, seg, size):
    tleaf, jleaf = _leaves(sum(seg), size, seg, mode)
    tpay, tship = twire.encode_message(twire.UP, 3, 7, [tleaf], mode=mode,
                                       seg=seg, aux=0.25)
    jpay, jship = jwire.encode_message(jwire.UP, 3, 7, [jleaf], mode=mode,
                                       seg=seg, aux=0.25)
    oracle, oship = twire.encode_arena_leaf_segments(tleaf, mode, seg)
    assert tpay[jwire.ENVELOPE_BYTES:] == oracle
    assert torch.equal(tship[0].values, oship.values)
    assert len(tpay) == twire.frame_bytes(tleaf, mode=mode, seg=seg) \
        == twire.frame_bytes_static(seg, size, mode)
    if mode == "tern" and seg == LONG:
        t0, ts, t1 = _split_scales(tpay, len(seg), mode)
        j0, js, j1 = _split_scales(jpay, len(seg), mode)
        assert (t0, t1) == (j0, j1)
        np.testing.assert_allclose(ts, js, rtol=TERN_RTOL)
    else:
        assert tpay == jpay
        np.testing.assert_array_equal(tship[0].values.numpy(),
                                      np.asarray(jship[0].values))


@pytest.mark.parametrize("mode", MODES)
def test_each_package_decodes_the_others_frames(mode):
    seg, size = LONG, 70000
    tleaf, jleaf = _leaves(sum(seg), size, seg, "dec", mode)
    tpay, tship = twire.encode_message(twire.DOWN, twire.COORDINATOR_ID, 4,
                                       [tleaf], mode=mode, seg=seg)
    jpay, jship = jwire.encode_message(jwire.DOWN, jwire.COORDINATOR_ID, 4,
                                       [jleaf], mode=mode, seg=seg)
    # the reference decodes the port's frame to the port's shipped values
    jdec = jwire.decode_message(tpay)
    assert (jdec.type, jdec.sender, jdec.seq) == (jwire.DOWN,
                                                   jwire.COORDINATOR_ID, 4)
    np.testing.assert_array_equal(np.asarray(jdec.leaves[0].values),
                                  tship[0].values.numpy())
    np.testing.assert_array_equal(np.asarray(jdec.leaves[0].indices),
                                  tleaf.indices.numpy())
    # the port decodes the reference's frame to the reference's values
    tdec = twire.decode_message(jpay, device="cpu")
    np.testing.assert_array_equal(tdec.leaves[0].values.numpy(),
                                  np.asarray(jship[0].values))
    np.testing.assert_array_equal(tdec.leaves[0].indices.numpy(),
                                  np.asarray(jleaf.indices))
    assert tdec.leaves[0].size == size
    assert tdec.leaves[0].indices.dtype == torch.int32


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,k", [(8, 3), (300, 7), (70000, 33)])
def test_sparse_leaf_frames_byte_identical(mode, n, k):
    """The per-leaf SPARSE framing (no seg): one scale per leaf."""
    tleaf, jleaf = _leaves(k, n, (k,), "leaf", mode)
    tframe, tship = twire.encode_leaf(5, tleaf, mode)
    jframe, jship = jwire.encode_leaf(5, jleaf, mode)
    if mode == "tern" and k > 20:
        assert len(tframe) == len(jframe) == \
            twire.leaf_frame_bytes(k, n, mode)
    else:
        assert tframe == jframe
    leaf_id, dec, end = twire.decode_leaf(jframe, device="cpu")
    assert leaf_id == 5 and end == len(jframe)
    np.testing.assert_array_equal(dec.values.numpy(),
                                  np.asarray(jship.values))
    np.testing.assert_array_equal(dec.indices.numpy(), tleaf.indices.numpy())


@pytest.mark.parametrize("nnz", [0, 3, 600], ids=["empty", "coo", "dense"])
def test_dense_frames_byte_identical(nnz):
    flat = np.zeros(1000, np.float32)
    flat[_rng("dense", nnz).choice(1000, nnz, replace=False)] = 1.5
    tpay, _ = twire.encode_message(twire.UP, 1, 2, [torch.from_numpy(flat)],
                                   aux=3.0)
    jpay, _ = jwire.encode_message(jwire.UP, 1, 2, [jnp.asarray(flat)],
                                   aux=3.0)
    assert tpay == jpay
    assert len(tpay) == twire.frame_bytes(torch.from_numpy(flat))
    dec = twire.decode_message(jpay, device="cpu")
    np.testing.assert_array_equal(dec.leaves[0].numpy(), flat)
    assert dec.aux == 3.0


def test_control_messages_and_constants_match_reference():
    for name in ("HELLO", "WELCOME", "UP", "DOWN", "SKIP", "BYE", "SUB",
                 "PULL", "SYNC", "DIFF", "COORDINATOR_ID", "SUBSCRIBER_BASE",
                 "SPARSE", "DENSE", "DENSE_COO", "ARENA"):
        assert getattr(twire, name) == getattr(jwire, name), name
    assert twire.TYPE_NAMES == jwire.TYPE_NAMES
    assert twire.MODES == jwire.MODES and twire.MODE_NAMES == jwire.MODE_NAMES
    for addr in (0, 5, twire.SUBSCRIBER_BASE, twire.COORDINATOR_ID - 1,
                 twire.COORDINATOR_ID - (1 << 16)):
        assert twire.is_subscriber(addr) == jwire.is_subscriber(addr)
    for t in (twire.HELLO, twire.WELCOME, twire.SKIP, twire.BYE):
        tpay, _ = twire.encode_message(t, 9, 0xFFFFFFFF)
        jpay, _ = jwire.encode_message(t, 9, 0xFFFFFFFF)
        assert tpay == jpay
        assert twire.decode_message(tpay, device="cpu") == \
            twire.Message(type=t, sender=9, seq=0xFFFFFFFF, aux=0.0,
                          leaves=[])
    two = [SparseLeaf(torch.ones(1), torch.zeros(1, dtype=torch.int32), 4)]
    with pytest.raises(ValueError, match="exactly one"):
        twire.encode_message(twire.UP, 0, 0, two * 2, seg=(1,))


def test_empty_arena_frame_is_header_only():
    leaf = SparseLeaf(torch.zeros(0), torch.zeros(0, dtype=torch.int32), 90)
    frame, shipped = twire.pack_from_arena(leaf, "int8", ())
    assert shipped is leaf
    assert frame == jwire.pack_from_arena(
        jsp.SparseLeaf(jnp.zeros(0), jnp.zeros(0, jnp.int32), 90), "int8",
        ())[0]


def test_sharded_frames_wait_for_their_slice():
    """The sharded frames have come (tests/test_torch_shard.py holds them
    to the reference): an int8 message over two shards, one of them with
    narrower indices, matches the reference byte for byte and its static
    sizes."""
    from repro.core.paramspace import ShardSpec as JShard
    from repro_torch.core.paramspace import ShardSpec as TShard

    seg, size = (4, 9, 20), 70000
    tleaf, jleaf = _leaves(sum(seg), size, seg, "shard")
    bounds, splits = (0, 60, size), (0, 2, 3)
    got = twire.encode_sharded_message(
        twire.UP, 0, 0, tleaf, shard_spec=TShard(bounds, splits),
        mode="int8", seg=seg)
    want = jwire.encode_sharded_message(
        jwire.UP, 0, 0, jleaf, shard_spec=JShard(bounds, splits),
        mode="int8", seg=seg)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [len(p) for p, _ in got] == list(twire.shard_frame_bytes_static(
        TShard(bounds, splits), seg, "int8"))


# ------------------------------------------------------------ build.py

_N_THREADS = (os.cpu_count() or 4) + 4     # more threads than cores


def _run_threads(threads, timeout=60.0):
    """Start and join ``threads`` with the interpreter switching threads
    every microsecond; every thread must finish."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_library_builds_once_across_threads(monkeypatch):
    """Many threads entering the first launch at once: exactly one build
    and one load, and every thread gets the same library."""
    builds = []

    def fake_build(verbose=False):
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)     # a slow nvcc widens the race
        return "libfake.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    loads = []
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: loads.append(path) or FakeLib())
    n = _N_THREADS
    got, barrier = [], threading.Barrier(n)

    def first_launch():
        barrier.wait(timeout=30)
        got.append(build.library())

    threads = [threading.Thread(target=first_launch) for _ in range(n)]
    _run_threads(threads)
    assert len(builds) == 1 and loads == ["libfake.so"]
    assert len(got) == n and all(lib is got[0] for lib in got)
    assert got[0].segment_quantize.restype is not None


def test_launch_counts_are_atomic():
    """Concurrent launches from more threads than cores, the interpreter
    switching threads as often as it can: no count is lost."""
    info = build.KernelInfo(name="k", source="s", replaces="r")
    n_threads, n_each = _N_THREADS, 2000

    def launch():
        for i in range(n_each):
            build.count(info, n=1 + i % 2)

    _run_threads([threading.Thread(target=launch) for _ in range(n_threads)])
    assert info.launches == n_threads * n_each * 3 // 2
