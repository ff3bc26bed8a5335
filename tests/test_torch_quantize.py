"""The port's segmented quantize on the CPU: the card's tern-sum order, the
fused plain version against its parts and against the JAX reference, and
the ARENA frame tail that the codec copies to the host in one piece.

Inputs are made with numpy.  The card's order (``wire_pack.tern_sum``) is
held to a plain Python loop of the order the kernel's source documents;
the fused plain version (``segment_quantize`` on a CPU tensor) to the
composition of ``quantize_scales_plain``, ``wire_codes_plain`` and
``tern_pack_plain`` bit for bit, and per row to the reference's
``quantize_segments`` (bit for bit but a tern scale over more than about
20 entries, a float32 sum XLA reorders: 1e-5 relative there).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import wire as jwire
from repro.core import sparsify as jsp
from repro_torch.cluster import wire as twire
from repro_torch.core import sparsify as tsp
from repro_torch.core.sparsify import SparseLeaf
from repro_torch.kernels import wire_pack as twp

CHUNK, LANES = twp.CHUNK, twp.LANES
TERN_RTOL = 1e-5


def _rng(*words):
    return np.random.default_rng(zlib.crc32(repr(words).encode()))


def _values(shape, *words, denormals=True):
    v = _rng(shape, *words).normal(size=shape).astype(np.float32)
    flat = v.reshape(-1)
    flat[::7] = 0.0
    flat[5::13] = -0.0
    if denormals:              # XLA's CPU backend flushes them to zero
        flat[3::11] = np.float32(1e-40)
    return v


def _loop_tern_sum(mag: np.ndarray) -> np.float32:
    """The order of csrc/wire_pack.cu, one float32 add at a time."""
    n = len(mag)
    chunks = []
    for c0 in range(0, max(n, 1), CHUNK):
        lanes = []
        for j in range(LANES):
            acc = np.float32(0.0)
            for p in range(c0 + j, min(c0 + CHUNK, n), LANES):
                acc = np.float32(acc + mag[p])
            lanes.append(acc)
        h = LANES // 2
        while h:
            lanes = [np.float32(lanes[i] + lanes[i + h]) for i in range(h)]
            h //= 2
        chunks.append(lanes[0])
    total = chunks[0]
    for part in chunks[1:]:
        total = np.float32(total + part)
    return total


@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan-inf"])
@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1, 3000, 4719,
                               2 * CHUNK + 5])
def test_card_order_tern_sum_is_the_documented_loop(n, special):
    # magnitudes spread over many binades, so that the order shows
    mag = np.abs(_values(n, "ts") * np.exp2(
        _rng(n, "exp").integers(-20, 20, n))).astype(np.float32)
    if special:
        mag[n // 2] = np.inf if n % 2 else np.nan
        mag[-1] = np.inf
    got = twp.tern_sum(torch.from_numpy(mag))
    want = _loop_tern_sum(mag)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_equal(got.numpy(), want)


def test_card_order_differs_from_left_to_right():
    """The two orders are not one sum: the card's order is its own."""
    mag = np.abs(_values(4719, "lr") * np.exp2(
        _rng("lr").integers(-20, 20, 4719))).astype(np.float32)
    card = twp.tern_sum(torch.from_numpy(mag))
    cpu = tsp._tern_sum(torch.from_numpy(mag))
    assert card.item() != cpu.item()
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=TERN_RTOL)


def test_card_order_tern_sum_rows():
    mag = np.abs(_values((5, CHUNK + 3), "rows"))
    rows = twp.tern_sum(torch.from_numpy(mag))
    assert rows.shape == (5,)
    for b in range(5):
        np.testing.assert_array_equal(rows[b].numpy(),
                                      _loop_tern_sum(mag[b]))


SEGS = {"one": (37,), "short": (4, 9, 20), "phase-b": (1049, 2, 4719, 1),
        "long": (3, CHUNK + 7, 1)}


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("seg", list(SEGS.values()), ids=list(SEGS))
@pytest.mark.parametrize("mode", ["bf16", "int8", "tern"])
def test_fused_plain_is_the_composition(mode, seg, B):
    v = torch.from_numpy(_values((B, sum(seg)), "fused", mode))
    scales = torch.cat([tsp.quantize_scales_plain(part, mode) for part in
                        torch.split(v, list(seg), dim=1)], dim=1)
    codes, dq = twp.wire_codes_plain(v, scales, seg, mode)
    form = "packed" if mode == "tern" else "element"
    got = twp.segment_quantize(v, seg, mode, codes=form)
    assert got.scales.shape == (B, len(seg))
    assert torch.equal(got.scales.view(torch.int32), scales.view(torch.int32))
    assert torch.equal(got.dq.view(torch.int32), dq.view(torch.int32))
    want = twp.tern_pack_plain(codes) if mode == "tern" else codes
    assert got.codes.dtype == want.dtype and torch.equal(got.codes, want)
    # the simulator's quantizer is the same function
    sim = tsp.quantize_segments(v, mode, seg)
    assert torch.equal(sim.view(torch.int32), dq.view(torch.int32))
    # and each row is the reference's segment-wise quantize
    v = _values((B, sum(seg)), "ref", mode, denormals=False)
    dq = twp.segment_quantize(torch.from_numpy(v), seg, mode).dq
    for b in range(B):
        ref = np.asarray(jsp.quantize_segments(jnp.asarray(v[b]), mode, seg))
        if mode == "tern" and max(seg) > 20:
            np.testing.assert_allclose(dq[b].numpy(), ref, rtol=TERN_RTOL)
        else:
            np.testing.assert_array_equal(dq[b].numpy(), ref)


def test_tern_packs_across_segment_edges():
    """A byte's four codes may come from two segments (a segment of 1 or
    2 codes has no byte of its own): the packed row is the packing of the
    whole row's signs."""
    seg = (1, 2, 5, 1, 3)
    v = torch.tensor([[-1.0, 2.0, -0.0, 3.0, 0.0, -4.0, 5.0, 6.0, -7.0, 8.0,
                       0.5, -0.5]])
    got = twp.segment_quantize(v, seg, "tern", codes="packed")
    signs = [-1, 1, 0, 1, 0, -1, 1, 1, -1, 1, 1, -1]
    assert got.codes[0].numpy().tobytes() == \
        jwire._pack_tern(np.asarray(signs, np.int8))


def test_int8_codes_of_nan_are_zero():
    v = torch.tensor([[1.0, float("nan"), -2.0, 0.0]])
    got = twp.segment_quantize(v, (2, 2), "int8", codes="element")
    assert torch.isnan(got.scales[0, 0]) and torch.isnan(got.dq[0, :2]).all()
    assert got.codes[0, :2].tolist() == [0, 0]
    assert got.codes[0, 2:].tolist() == [-127, 0]


@pytest.mark.parametrize("seg,chunks,multi", [
    ((5,), (1,), False), ((0, CHUNK), (1, 1), False),
    ((CHUNK + 1, 3), (2, 1), True), ((4 * CHUNK,), (4,), True)])
def test_plan_cuts_segments_into_chunks(seg, chunks, multi):
    got, n_work, longest = twp._plan(seg)
    assert got == chunks and n_work == sum(chunks)
    assert (longest > CHUNK) == multi


def _frame_tail_of(frame: bytes, n_seg: int) -> bytes:
    """An ARENA frame's bytes after the header and the segment table."""
    return frame[4 + 12 + 4 * n_seg:]


@pytest.mark.parametrize("size", [256, 5000, 70000], ids=["u8", "u16", "u32"])
@pytest.mark.parametrize("seg", [(4, 9, 20), (100, 30, 125)],
                         ids=["short", "odd"])
@pytest.mark.parametrize("mode", ["none", "bf16", "int8", "tern"])
def test_frame_tail_is_the_frames_tail(mode, seg, size):
    k = sum(seg)
    rng = _rng(k, size, mode, "tail")
    idx = np.sort(rng.choice(size, k, replace=False)).astype(np.int32)
    v = _values(k, size, mode, "tail", denormals=False)
    leaf = SparseLeaf(torch.from_numpy(v), torch.from_numpy(idx), size)
    tail, shipped = twp.frame_tail(leaf.values, leaf.indices, seg, mode,
                                   size)
    frame, oship = twire.encode_arena_leaf_segments(leaf, mode, seg)
    assert tail.dtype == torch.uint8
    assert tail.numpy().tobytes() == _frame_tail_of(frame, len(seg))
    assert torch.equal(shipped, oship.values)
    idx_off, code_off, end = twp._tail_layout(k, len(seg), mode, size)
    assert end == tail.numel() == twire.arena_frame_bytes(seg, size, mode) \
        - (4 + 12 + 4 * len(seg))
    assert code_off - idx_off == twp.index_width(size) * k
    assert twp.index_width(size) == np.dtype(twire.index_dtype(size)).itemsize
    if mode != "tern" or max(seg) <= 20:
        jframe, _ = jwire.pack_from_arena(
            jsp.SparseLeaf(jnp.asarray(v), jnp.asarray(idx), size), mode,
            seg)
        assert _frame_tail_of(jframe, len(seg)) == tail.numpy().tobytes()


def test_pack_from_arena_copies_one_tail():
    """The encoder's frame is header + segment table + the one tail."""
    seg, size = (4, 9, 20), 5000
    k = sum(seg)
    idx = np.arange(0, 3 * k, 3, dtype=np.int32)
    leaf = SparseLeaf(torch.from_numpy(_values(k, "one")),
                      torch.from_numpy(idx), size)
    frame, shipped = twire.pack_from_arena(leaf, "int8", seg)
    tail, dq = twp.frame_tail(leaf.values, leaf.indices, seg, "int8", size)
    assert frame.endswith(tail.numpy().tobytes())
    assert len(frame) == twire.arena_frame_bytes(seg, size, "int8")
    assert torch.equal(shipped.values, dq)
