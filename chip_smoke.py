#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

It takes no arguments and runs every phase, in order (a failure in any
exits nonzero and prints no result line):

* kernels -- builds the hand-written CUDA kernels from ``src/repro_torch/
  kernels/csrc`` and holds each against its plain PyTorch version on the card,
  bit for bit (-0 and +0 differ; NaN bits too, but for the elementwise
  kernels 4, 4a and 4b, whose NaNs all read as one), at the main path's
  shapes; times kernel, plain version and the nearest library call, beside
  the memory bound.  The flat scatter-add also meets adversarial cases (all
  updates on one index or in one CTA's range, duplicates across the
  kernel's rounds, out-of-range indices, -0 runs with +0 pads, k = 0 and
  1), the block top-k adversarial blocks (all equal, zeros of both signs,
  denormals, ties across lanes, infinities) at r from 1 to 1024 around its
  regime switch and at a 4-byte offset, and its row regime (``row_topk``,
  a row's exact top-k in one CTA) against the plain version and the
  hierarchy at the benchmark cells' row shapes and at k = 1, around 64,
  above 1,024 and k = n, on rows of 37, 1,000, 4,096 and ROW_MAX
  elements, adversarial rows planted, at a 4-byte offset and strided, and
  the engine's switch at ROW_MAX; the multi-row scatter-add one such
  case per lane of 16 permuted rows, each lane alone (B = 1), the identity
  rows, k = 0 and 600 lanes; the fused SAMomentum pass rows of 10, 2,049
  and 2,304 elements at 0-, 4- and 8-byte offsets with ties, denormals,
  +-0, +-inf and NaN, aliased and separate u and g, and the
  4,718,592-element leaf and 16 rows of it; its float32 fused
  multiply-adds (the velocity accumulate, fma) values within an ulp of a
  float32 halfway point, IEEE corner cases and every operand form on
  strided leaf views.  Each reports the C call alone and the wrapper's
  host time per call.  The segmented quantize (rows 5-6: scales, codes,
  shipped values and packed tern codes in one launch) is held byte for
  byte in bf16, int8 and tern at a message of phase B (k = 10,514 in 8
  segments), at one 4,718,592-element vector and at a (16, k) batch, with
  NaN, +-inf, +-0, denormals, int8 and bf16 halfway values, an all-zero
  segment and a segment of one element planted; the codec's frame tails
  and frames too, a delta checkpoint's one long segment among them.
* a -- the quickstart configuration (8 workers, 600 events, asgd and dgs) on
  the card and on the CPU from the same weights and numpy batches; bytes,
  losses and accuracy must agree within the stated tolerances.
* b -- full width: the 10.5M-parameter MLP (512-2048-2304-2048-10), 100
  workers, dgs at density 0.001 with the blockwise engine on both sides,
  96 events through the serial loop, ``AsyncTrainer.run``.  Every kernel's
  launch counter must rise (the serial worker step is the row-wise one at
  B = 1, so its support repair is the multi-row scatter-add); losses are
  finite and the wire bytes are the static frame sizes; the segmented
  quantize launches exactly once per event and the fma only in the
  repair (once per leaf and event).  Prints events/s,
  the per-stage split, peak memory and a profiler window's device time by
  kernel, in which no float64 kernel may run.
* e -- phase B's configuration, schedule and batches (stacked on the card)
  through the scan runner, ``run_async_scan``: event 0 eagerly, then ONE
  CUDA graph of the event replayed for the other 95 (run right after B).
  It must be bit-equal to phase B (losses, final params, M, v, bytes), and
  every kernel's launch count must equal phase B's (each replay adds the
  capture's recorded launches; the segmented quantize once per event); a
  run with ``metrics=True`` too, its drained counts the schedule's.
  Prints events/s beside phase B's, capture seconds, host us per replay,
  peak memory, and device ms/event and busy share from a profiler window
  over a further run's replays (where the trace shows no graph kernels:
  phase B's device ms/event over E's wall ms/event, said so).
* c -- phase B's configuration, schedule and batches through the batched
  loop, ``AsyncTrainer.run_batched`` with ``max_batch=16``, with a Recorder
  and the metrics on.  It must be bit-equal to phase B's run (losses, final
  params, M, v, bytes), and every kernel, kernel 4 included, must launch
  (the segmented quantize exactly once per batch).
  Prints events/s, the mean batch, launches per event, the host span
  totals per stage and peak memory.
* d -- the cluster runtime at full width: phase B's model, schedule,
  batches and 100 worker slots through ``cluster.run_inprocess`` (50 client
  threads and the coordinator, every message through the wire codec, one
  launch of the segmented quantize per encode).  D1 (int8 up, none down)
  must be bit-equal to phase B; D2
  (tern up, bf16 down) bit-equal to the port's serial ``AsyncTrainer.run``
  of its configuration, run here; D3 runs ``python -m
  repro_torch.launch.cluster --smoke`` (two client processes over TCP) and
  needs exit code 0; D4 runs the launcher at phase B's widths (4 client
  processes, 8 rounds, int8 up) and holds its events and
  measured bytes to an in-process run of the same problem.  Prints
  events/s, peak memory, launches per event, the coordinator's mean batch
  and the host span totals of each run.
* f -- serving and delta checkpoints at full width.  F1 is phase D1's run
  with the serve leg on: two inference replica threads (blockwise pushes
  at density 0.001 with ``block_r=32``, int8 on the wire, staleness bound
  4, each decode the MLP's accuracy on 512 samples) and a delta chain
  appended every 8 events.  Its training must be bit-equal to phase B
  (losses, worker ids, staleness, final params, bytes), both replicas'
  arenas bit-equal to the server's final arena at version 96, the chain
  restored on the card equal to it (version 96, as many deltas as the
  ``ckpt_deltas`` counter) and again after ``compact`` of its first half;
  the launches beyond D1's must cover the pushes' (a segmented quantize
  and a flat scatter-add commit per push, a block top-k per leaf per
  push, a flat scatter-add per applied diff).  Prints events/s beside
  D1's, each replica's pushes, push bytes, lag and stale waits, the serve
  spans' host totals, the chain's bytes and restore seconds, and peak
  memory.  F2 runs ``python -m repro_torch.launch.serve --smoke`` (TCP, a
  client and two replica processes, a checkpoint directory) and needs exit
  code 0; F3 runs the fleet launcher at phase B's widths (4 client and 2
  replica processes, 8 rounds) and holds both replicas' arenas and the
  restored chain equal, the chain ending at version 32.
* g -- the sharded parameter servers at full width, S = 4 (the arena's
  leaf-aligned bounds leave shard 2 empty).  G1 is phase D1's run through
  ``run_inprocess(n_shards=4)`` (four coordinator threads, every client
  fanning its UP out as four frames): losses, worker ids, staleness and
  final params bit-equal to D1, the bytes the per-shard static frames
  (four envelopes an event), every shard's ``events`` 96 and
  ``arena_elems`` its size.  G2 runs it through ``run_inprocess(
  mesh_shards=4)`` (one coordinator, the four arenas stacked on the card,
  every batch through the route exchange): bit-equal to D1 bytes included,
  ``route_overflow`` 0.  G3 runs the TCP launcher's coordinator side at
  phase B's widths (4 client processes, 8 rounds) as a 1-shard lockstep
  run, as ``--shards 4`` (clients ``--pin-slot``) and as
  ``--mesh-shards 4``, each sharded run bit-equal to the lockstep one (the
  mesh run in bytes too).  Each prints events/s beside D1's, launches per
  event by kernel, the host span totals and peak memory.  The kernel
  phase holds the flat scatter-add at the route's buffer shape and the
  multi-row one at the mesh's S-lane and B*S-lane shapes, ``-1`` slots
  and +-0 planted.  For H it holds rows 2, 3, 4, 4a and 4b at H1's
  largest leaf as the exchange cuts it (the embedding's (65,024, 4,096)
  rows, k_row 205, r = 205, the repair and the union scatter 65,024 lanes
  in launches of 512, shardedps's receive and downward scatter), and row
  3 at r = 410 on the MLP leaves' view.

* h -- the data-parallel training path (``launch/steps.build_train_step``
  over ``core/distributed.exchange``).  H1 trains chatglm3-6b at its
  published widths (d_model 4,096, 32 heads, 2 KV heads, d_ff 13,696,
  vocab 65,024, partial rotary, qkv bias, bf16 compute over float32
  parameters), its depth cut from 28 layers to 2 (940,602,368
  parameters), on W = 4 lanes of the card (a ``LaneMesh``), batch 16 x seq
  128, 5 steps each of allgather, shardedps and dense with the blockwise
  engine: losses and parameters finite, rows 1, 2, 3, 4 and 4a launched
  by allgather, shardedps's overflow read out; then one step with a
  bucket for every entry and a dense downward pass, where shardedps must
  give the allgather update and velocity and M == v (atol 1e-5).  Prints
  each step's gradients / exchange / update split by CUDA events, tokens/s,
  peak memory, launches per step and the exchange's static wire bytes per
  worker and step.  H2 holds the reduced chatglm3 (float32 compute, 5
  allgather steps) on the card against the CPU: with the exact engine end
  to end, losses rtol 1e-4, parameters atol 1e-5 but at counted support
  swaps, each of which must lie within 1e-5 (relative) of its row's
  selection boundary; with the blockwise engine, the card's exchange fed
  the CPU's gradients must give the CPU's parameters and velocities bit
  for bit.  H3 runs
  two processes on the card as a ``ProcessMesh`` over gloo (staged
  operands), 3 steps of H1's model at 1 layer: both ranks' parameters
  bit-equal to each other's and to a ``LaneMesh(2)`` run, and the route of
  16 phase B messages over the ranks (``use_mesh=True``) bit-equal to the
  one-card leg.  H4 runs ``python -m repro_torch.launch.train --steps 5``
  (``--devices 8``: the reference's (4 data, 2 model) mesh, which its log
  must name) and needs exit code 0.
* i -- prefill and KV-cache decode of the dense GQA family
  (``models.prefill``, ``models.decode_step``, ``launch/steps.
  build_serve_step``); no kernel of the port lies on this path, and the
  launch counters are printed.  I1 prefills H1's model (chatglm3-6b at its
  published widths, 2 layers) with a numpy prompt of 16 x 1,024 tokens and
  decodes 64 greedy tokens: finite logits, ids in range, the caches'
  bytes; prints prefill ms, decode ms a step (median by CUDA events),
  tokens/s, peak memory and the cache bytes.  I2 times 10 decode steps
  from ``concrete_inputs`` at the assigned decode shapes: chatglm3-6b (2
  layers) at decode_32k (B 128, cache 32,768) and long_500k (B 1, an
  8,192-slot ring at position 262,144), gemma3-12b (one unit: 5 local
  layers, 1 global) at decode_32k with B cut to 16; each prints ms a step,
  tokens/s, peak memory and its bound.  I3 holds the card against the CPU
  on the reduced chatglm3 and gemma3, float32 and bf16 compute: a prompt
  of 60 and 16 greedy steps, float32 logits to rtol/atol 1e-4, tokens
  equal wherever the CPU's top-2 margin exceeds 1e-3 (float32) or 5e-2
  (bf16).  I4 runs ``python -m repro_torch.launch.serve --role decode``
  and needs exit code 0 and 4 rows of 16 ids in [0, vocab).
* j -- the MoE family (``models/moe.py``: router, dense and capacity
  dispatch, aux losses) through forward, loss, prefill and decode; no
  kernel of the port lies on its forward path.  J1 prefills
  qwen3-moe-235b-a22b at its published widths (d_model 4,096, 64 heads, 4
  KV heads, 128 experts of 1,536, top-8, capacity factor 1.25, capacity
  dispatch, vocab 151,936), 2 of 94 layers (6,220,173,312 parameters),
  with I1's prompt of 16 x 1,024 and decodes 64 greedy tokens: finite
  logits, ids in range, the prefill's C 1,280 a layer and finite aux;
  prints prefill ms, decode ms a step against its bound, tokens/s, peak
  memory, each call's C and the share of (token, choice) pairs dropped
  (counted by wrapping ``moe.dispatch`` in untimed calls), and a profiled
  step.  J2 times 10 decode steps from ``concrete_inputs``: qwen3-moe (2
  layers) at decode_32k (B 128, C 10) and long_500k (B 1, C 1), dbrx-132b
  (1 layer) at decode_32k, each against ``_decode_bound`` (of the
  experts only those with a kept pair read, only the kept pairs
  multiplied).  J3 holds the card against the CPU on the reduced qwen3-moe
  and dbrx, dense and capacity dispatch (and dbrx at 8 experts, where
  pairs drop), float32 and bf16: I3's logits and token gates, the loss
  with its aux to rtol 1e-4, the router's ids at every float32 layer and
  token whose margin exceeds 1e-6 (at most 1 in 1,000 excused); then one
  MoE train step (reduced qwen3-moe, capacity, W = 4 lanes): the
  blockwise allgather step launches rows 1-4b (counted over that step),
  H2a's gate on the exact engine's step and H2b's on the blockwise
  exchange fed the CPU's gradients.  J4 runs ``launch/serve.py --role
  decode --arch qwen3-moe-235b-a22b`` and ``launch/train.py --arch
  dbrx-132b --steps 3``; both must exit 0.
* k -- MLA (minicpm3-4b), the Mamba2/SSD block (mamba2-780m) and the
  hybrid with shared attention (zamba2-2.7b); no kernel of the port lies
  on their forward path.  K1 prefills each at its published widths
  (minicpm3 2 of 62 layers, mamba2 all 48, zamba2 one unit of 5 mamba and
  1 mamba_attn blocks) with I1's prompt and decodes 64 greedy tokens,
  against ``_decode_bound``; K2 times 10 decode steps from
  ``concrete_inputs`` at decode_32k and long_500k (minicpm3 expanded at B
  16 and absorbed at B 128, zamba2 at B 32), each cut printed; K3 holds
  the card against the CPU on the reduced models under I3's gates, and
  ``ssd_chunked`` against the float64 recurrence (atol 1e-4); K4 runs one
  blockwise allgather train step of each at full width on W = 4 lanes
  (rows 1-4b launched; rows 4-4b on 73,448 rows, more than a grid's y
  holds, bit-equal to their plain versions) and ``_train_gates`` on the
  reduced ones; K5 runs the six launchers at once, each exiting 0.
* l -- M-RoPE and the modality frontends: qwen2-vl-7b (M-RoPE sections
  (16, 24, 24) over a 32 x 32 patch grid) and musicgen-large (sinusoidal
  positions, 512 frame embeddings); no kernel of the port lies on their
  forward path.  L1 prefills qwen2-vl at its published widths, 2 of 28
  layers, with 16 x 1,280 (1,024 patch embeddings, then 256 tokens) and
  musicgen, all 48 layers, with 16 x 1,024 (512 frames, then 512
  tokens), the embeddings a seeded numpy draw in bf16, and decodes 64
  greedy tokens against ``_decode_bound``; L2 times 10 decode steps from
  ``concrete_inputs`` at decode_32k and long_500k (qwen2-vl 2 layers at B
  128 and B 1; musicgen 4 layers at B 16, and all 48 at B 1), each cut
  printed; L3 holds the card against the CPU on the reduced models with
  their frontend embeddings, float32 and bf16, under I3's gates; L4 runs
  one blockwise allgather train step of each at full width (qwen2-vl 1
  layer, global batch 8 x 1,280; musicgen 8 layers, 16 x 640; W = 4
  lanes unless the printed reckoning passes 72 GiB) with rows 1-4b
  launched, then ``_train_gates`` on the reduced ones; L5 runs the four
  launchers at once, each exiting 0.  The launch counters over L1-L3 are
  printed (0 expected).
* m -- the ``"model"`` mesh axis (``models/tensor_parallel.py``: tensor
  parallelism of the projections and the vocabulary, expert parallelism
  of the MoE; the exchange on each shard's rows).  M1 trains H1's model
  (chatglm3-6b, 2 layers, bf16) on ``LaneMesh(2, model=2)`` and on
  ``LaneMesh(2, model=1)``, 3 blockwise allgather steps each: the split
  by CUDA events, peak memory, launches a step (rows 1-4b must launch at
  model size 2), a profiled step; then, float32 compute, each of 3 steps
  from model size 1's state on both meshes under H2a's gates (a swap
  within ``M_TIE`` of its boundary; its velocity differs by ``a (1/m -
  1)``).  M1b holds the reduced chatglm3 and qwen3-moe at model size 2
  on the card to the CPU under ``_train_gates``: rows 1-4b launched, the
  blockwise exchange fed the CPU's gradients bit-equal to the CPU's
  plain versions.  M2 runs four processes on the card as a (2, 2)
  ``ProcessMesh`` over gloo, 1 layer: each rank's shards of the
  parameters and its lane's velocity bit-equal to a ``LaneMesh(2,
  model=2)`` run's, its resident bytes within 1% of its shards' (the NCCL
  leg and qwen3-moe's full-width step at model size 4 need four cards:
  printed as unverified).  M3 prefills I1's prompt and decodes 64 greedy
  tokens at model size 2 and 1 through the prefill and serve steps
  (chatglm3-6b and qwen3-moe-235b-a22b, 2 layers), then holds the reduced
  ones at model size 2, card against CPU, to I3's gates.  M4 runs
  ``launch.train --devices 8`` and ``launch.serve --role decode
  --devices 4``; both exit 0 and name their meshes.

* n -- the model axis at the production meshes' model size 16, the
  examples, the roofline and the dry run.  N1 trains mamba2-780m and
  minicpm3-4b at their published widths and vocabularies (2 layers each;
  16 divides neither 50,280 nor 73,448, so the embedding goes on d and
  the head is whole; minicpm3's 40 MLA heads do not split over 16 either)
  on ``LaneMesh(2, model=16)`` and ``LaneMesh(2, model=1)``, 2 blockwise
  allgather steps each (the split, peak, launches; rows 1-4a must launch
  at 16), then M1's float32 gates at 16 against 1 (the model-1 step cut
  as the model-16 one); prefill of I1's prompt and 64 greedy tokens on
  ``LaneMesh(1, model=16)`` against ``(1, model=1)`` under I3's gates, ms
  a step and peak of each; and ``_train_gates`` at model 16 on reduced
  models of the same layout (rows 1-4b bit-equal to their plain
  versions).  N2 runs ``examples/federated_noniid_torch.py``,
  ``serve_decode_torch.py`` and ``bandwidth_study_torch.py --quick`` on
  the card at once: each exits 0 (federated's bytes are its frames',
  serve_decode's replica and delta chain bit-identical to the server),
  their launch counts printed.  N3 holds ``launch/dryrun.reckon`` of M2's
  problem to the 2,946,615,296 bytes of M2's shards and to every M2
  rank's measured resident bytes (within 1%), ``FlopCounterMode`` on the
  meta device to its count on the card for H1's gradients, and prints
  H1's step beside the roofline's three terms (``launch/roofline.py``,
  whose H100 constants this script reads), ``model_flops / (step s x
  peak)`` under 1.05.

The kernel rows carry ``launches_m_per_step`` (M1 at model size 2),
``launches_n1_per_step`` (N1 at 16) and ``launches_n2`` (the examples)
beside their other counts.  The last two lines are the kernel table and the
result, each one JSON object.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


NAN_BITS = 0x7FC00000      # the canonical float32 NaN


def log(*args):
    print(*args, flush=True)


def card_rate(name: str) -> float:
    """The card's memory rate (``repro_torch.launch.roofline.HBM_RATE``;
    ``scripts/chip_kernel_ab.py`` reads it here in every checkout)."""
    from repro_torch.launch.roofline import hbm_rate

    return hbm_rate(name)


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 15, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call, microseconds: ``calls`` calls enqueued back to
    back, no synchronization inside (the card runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(torch, timer, rate, results):
    from repro_torch.kernels import block_topk, scatter_apply

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}

    def bits(t, nan_as_one):
        """A tensor's bit pattern: -0 and +0 differ, as the kernels' must.
        With ``nan_as_one`` every float32 NaN reads as one pattern: IEEE
        754 leaves the sign and payload of a NaN that arithmetic makes to
        the implementation (the elementwise kernels' __fmaf_rn against
        their plain versions' float64 emulation).  Without it a NaN's bits
        must match too (the kernels that copy or scatter their inputs)."""
        if t.dtype == torch.float32:
            if nan_as_one:
                return torch.where(torch.isnan(t), NAN_BITS,
                                   t.view(torch.int32))
            return t.view(torch.int32)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16)
        return t

    def compare(name, got, want, quiet=False, nan_as_one=False):
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                     f"{w.shape}/{w.dtype}")
            gb, wb = bits(g, nan_as_one), bits(w, nan_as_one)
            if not torch.equal(gb, wb):
                bad = int((gb != wb).sum())
                raise AssertionError(f"{name}: {bad} elements differ")
            if g.is_floating_point():
                # the bits are equal: only non-finite elements (whose
                # difference is NaN) are left out of the reported error
                ok = torch.isfinite(g) & torch.isfinite(w)
                err = float((g.double() - w.double())[ok].abs().max()) \
                    if bool(ok.any()) else 0.0
                errs[name.split("/")[0]] = max(errs.get(name.split("/")[0],
                                                        0.0), err)
        errs.setdefault(name.split("/")[0], 0.0)
        if not quiet:
            log(f"  {name}: bit-equal")

    # 1. scatter-add at the arena size, k = density 0.001 of every tensor
    from repro_torch.kernels import build
    n, k = 10_512_650, 10_514
    dense = torch.randn(n, generator=gen, device="cuda")
    idx = torch.randperm(n, generator=gen, device="cuda")[:k].to(torch.int32)
    vals = torch.randn(k, generator=gen, device="cuda")
    dense[idx[:60].long()] = -torch.zeros(60, device="cuda")
    for name, ii, vv in scatter_cases(torch, gen, n, idx, vals):
        a = scatter_apply.scatter_add_(dense.clone(), ii, vv)
        b = scatter_apply.scatter_add_plain(dense.clone(), ii, vv)
        compare(f"scatter_add/{name}", (a,), (b,))
        del a, b
    d1, d2, d3 = dense.clone(), dense.clone(), dense.clone()
    ms = timer(lambda: scatter_apply.scatter_add_(d1, idx, vals))
    plain_ms = timer(lambda: scatter_apply.scatter_add_plain(d2, idx, vals))
    lib_ms = timer(lambda: d3.index_add_(0, idx, vals))
    # the launch alone: the C call on the same operands
    launch_ms = timer(lambda: build.library().scatter_add(
        d1.data_ptr(), n, idx.data_ptr(), vals.data_ptr(), k,
        build.stream()))
    # k indices + k values read, k target words read and written
    nbytes = 4 * k + 4 * k + 8 * k
    host = (host_us(torch, lambda: scatter_apply.scatter_add_(d1, idx, vals)),
            host_us(torch, lambda: d3.index_add_(0, idx, vals)))
    log(f"  scatter_add (n={n}, k={k}): wrapper {ms:.4f} ms (launch alone "
        f"{launch_ms:.4f} ms), plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {nbytes / rate * 1e3:.5f} ms; host per "
        f"call: wrapper {host[0]:.1f} us, index_add_ {host[1]:.1f} us")
    results.append(dict(
        name=scatter_apply.INFO.name, route="cuda",
        source=scatter_apply.INFO.source, replaces=scatter_apply.INFO.replaces,
        max_abs_err=errs["scatter_add"], ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / rate * 1e3, bound_by="bytes", library_ms=lib_ms,
        launch_ms=launch_ms))
    del d1, d2, d3

    # 2. block top-r on the 4,718,592-element leaf (w1 / w2 of the MLP)
    n2 = 2304 * 2048
    x = torch.randn(n2, generator=gen, device="cuda")
    x[::7] = 0.5                  # planted magnitude ties
    x[3::11] = -0.5
    plant_blocks(torch, gen, x.view(-1, block_topk.BLOCK))
    x2d = x.reshape(-1, block_topk.BLOCK)
    # the same blocks at a 4-byte offset: the kernel's scalar-load path
    shifted = torch.empty(n2 + 1, device="cuda")
    shifted[1:] = x
    x2d_odd = shifted[1:].view(-1, block_topk.BLOCK)
    sel_max = block_topk.SELECT_MAX_R
    for r in (1, 2, 4, 20, 31, 32, 33, sel_max, sel_max + 1, 1023, 1024):
        compare(f"block_topk/r={r}", block_topk.block_topk_2d(x2d, r=r),
                block_topk.block_topk_plain(x2d, r))
        compare(f"block_topk/r={r}, 4-byte offset",
                block_topk.block_topk_2d(x2d_odd, r=r),
                block_topk.block_topk_plain(x2d, r), quiet=True)
    log("  block_topk: every r also bit-equal at a 4-byte offset")
    del shifted, x2d_odd
    nb = x2d.shape[0]
    timings = {}
    for r in (32, sel_max, sel_max + 1, 1024):
        vals_o = torch.empty((nb, r), device="cuda")
        idx_o = torch.empty((nb, r), dtype=torch.int32, device="cuda")
        timings[r] = dict(
            ms=timer(lambda: block_topk.block_topk_2d(x2d, r=r)),
            launch_ms=timer(lambda: build.library().block_topk(
                x2d.data_ptr(), vals_o.data_ptr(), idx_o.data_ptr(), nb, r,
                build.stream())),
            plain_ms=timer(lambda: block_topk.block_topk_plain(x2d, r)),
            library_ms=timer(lambda: torch.topk(x2d.abs(), r, dim=1)),
            bound_ms=(4 * n2 + 8 * nb * r) / rate * 1e3)
        del vals_o, idx_o
        t = timings[r]
        host = host_us(torch, lambda: block_topk.block_topk_2d(x2d, r=r))
        log(f"  block_topk r={r} ({'select' if r <= sel_max else 'sort'}): "
            f"kernel {t['ms']:.4f} ms (launch alone {t['launch_ms']:.4f} ms),"
            f" plain {t['plain_ms']:.4f} ms, torch.topk "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; host "
            f"per call {host:.1f} us")
    t, t32 = timings[1024], timings[32]
    results.append(dict(
        name=block_topk.INFO.name, route="cuda", source=block_topk.INFO.source,
        replaces=block_topk.INFO.replaces, max_abs_err=errs["block_topk"],
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by="bytes", library_ms=t["library_ms"],
        launch_ms=t["launch_ms"], r32_ms=t32["ms"],
        r32_launch_ms=t32["launch_ms"], r32_plain_ms=t32["plain_ms"],
        r32_bound_ms=t32["bound_ms"], r32_library_ms=t32["library_ms"]))
    row_kernels(torch, timer, rate, results, compare, errs)
    sam_row_kernels(torch, timer, rate, results, compare, errs)

    # 3. fused SAMomentum (kernel 4), its float32 fused multiply-adds
    # (4a, 4b) and the multi-row scatter-add (kernel 2)
    samomentum_kernels(torch, timer, rate, results, compare, errs)
    scatter_rows_kernel(torch, timer, rate, results, compare, errs)
    shard_kernels(torch, timer, rate, results, compare)
    h_kernels(torch, timer, rate, results, compare)

    # the row-wise calls of the block top-k at the batched worker step's
    # shapes: 16 rows of the 4,718,592-element leaf, k = 4,719, r = 1024
    from repro_torch.kernels import ops
    B = 16
    xr = torch.randn(B, n2, generator=gen, device="cuda")
    xr[:, ::7] = 0.5
    xr[:, 3::11] = -0.5
    k2 = 4719
    singles = [ops.hierarchical_topk(xr[i], k=k2, r=1024) for i in range(B)]
    compare("hierarchical_topk/rows vs 16 single rows",
            ops.hierarchical_topk_rows(xr, k=k2, r=1024),
            (torch.stack([v for v, _ in singles]),
             torch.stack([i for _, i in singles])))
    del singles
    rows_ms = timer(lambda: ops.hierarchical_topk_rows(xr, k=k2, r=1024),
                    reps=5)
    single_ms = timer(lambda: [ops.hierarchical_topk(xr[i], k=k2, r=1024)
                               for i in range(B)], reps=5)
    log(f"  hierarchical_topk (16, {n2}), k={k2}, r=1024: rows "
        f"{rows_ms:.4f} ms, 16 single calls {single_ms:.4f} ms")
    nb2 = B * n2 // block_topk.BLOCK
    xr2d = xr.view(-1, block_topk.BLOCK)
    vals_o = torch.empty((nb2, 1024), device="cuda")
    idx_o = torch.empty((nb2, 1024), dtype=torch.int32, device="cuda")
    bt_ms = timer(lambda: block_topk.block_topk_2d(xr2d, r=1024), reps=5)
    bt_launch_ms = timer(lambda: build.library().block_topk(
        xr2d.data_ptr(), vals_o.data_ptr(), idx_o.data_ptr(), nb2, 1024,
        build.stream()), reps=5)
    del vals_o, idx_o
    bt_lib_ms = timer(lambda: torch.topk(xr2d.abs(), 1024, dim=1), reps=5)
    bt_bound = (4 * B * n2 + 8 * nb2 * 1024) / rate * 1e3
    log(f"  block_topk rows launch ({nb2}, 1024), r=1024: kernel "
        f"{bt_ms:.4f} ms (launch alone {bt_launch_ms:.4f} ms), torch.topk "
        f"{bt_lib_ms:.4f} ms, bound {bt_bound:.4f} ms")
    row = next(r for r in results if r["name"] == block_topk.INFO.name)
    row.update(rows16_ms=bt_ms, rows16_launch_ms=bt_launch_ms,
               rows16_library_ms=bt_lib_ms, rows16_bound_ms=bt_bound)
    del xr
    wire_kernels(torch, timer, rate, results, compare, errs)
    for row in results:
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
            f"bound {row['bound_ms']:.5f} ms")


def halfway_cases(rng, size: int):
    """float32 (a, b, c) whose exact a * b + c lies within far less than a
    float32 ulp of a point halfway between two float32 values: rounded to
    float64 first it would land ON the halfway point, and a second rounding
    (to even) would err half the time.  Two families, scaled by powers of
    two and signed at random: a * b an odd integer in [2^24, 2^25) (itself
    a halfway point) plus a c of 2^-30 to 2^-60 of it; and a * b =
    64 - 2^-40 beside a c of magnitude [2^30, 2^31) with an odd last bit,
    whose ulp is 128."""
    h = size // 2
    a = np.concatenate([rng.integers(2048, 2896, h) * 2 + 1.0,
                        np.full(size - h, 8.0 + 2.0 ** -20)])
    b = np.concatenate([rng.integers(2048, 2896, h) * 2 + 1.0,
                        np.full(size - h, 8.0 - 2.0 ** -20)])
    c = np.concatenate([np.ldexp(1.0, -rng.integers(30, 60, h)),
                        (2.0 ** 23 + rng.integers(0, 2 ** 22, size - h) * 2
                         + 1) * 128.0])
    s1, s2 = rng.integers(-40, 40, size), rng.integers(-40, 40, size)
    a, b, c = np.ldexp(a, s1), np.ldexp(b, s2), np.ldexp(c, s1 + s2)
    sign = rng.choice([-1.0, 1.0], (3, size))
    return tuple((x * sg).astype(np.float32) for x, sg in zip((a, b, c), sign))


def special_cases():
    """float32 (a, b, c) of IEEE corner cases: (-0) * x + (-0) and its sign
    variants, denormal products and sums, overflow to and just below
    infinity, infinities (inf * 0 and inf - inf are NaN) and NaN."""
    inf, nan, tiny = float("inf"), float("nan"), 2.0 ** -70
    rows = [(-0.0, 3.0, -0.0), (0.0, -3.0, -0.0), (-0.0, -3.0, 0.0),
            (3.0, 0.0, -0.0), (tiny, tiny, 0.0), (tiny, -tiny, 1e-45),
            (tiny, tiny * 3, -1e-42), (2.0 ** -75, 2.0 ** -75, -0.0),
            (1e-38, 0.5, -1e-38), (2.0 ** 64, 2.0 ** 64, 0.0),
            (3.4028235e38, 1.0, 3.4028235e38 * 2.0 ** -24),
            (3.4028235e38, 1.0, 3.4028235e38 * 2.0 ** -25),
            (inf, 0.0, 1.0), (inf, 2.0, -inf), (inf, 2.0, 5.0),
            (-inf, 2.0, 5.0), (2.0, 3.0, inf), (nan, 1.0, 2.0),
            (1.0, nan, 2.0), (1.0, 2.0, nan), (1e30, 1e10, -inf)]
    return tuple(np.asarray(col, np.float32) for col in zip(*rows))


def samomentum_kernels(torch, timer, rate, results, compare, errs):
    """Kernel 4 (the fused SAMomentum pass) and its float32 fused
    multiply-adds, 4a (the velocity accumulate) and 4b (fma), against their
    plain versions bit for bit (every NaN as one).  Kernel 4: rows of 10,
    2,049 and 2,304 elements (rows that start off 16-byte alignment),
    inputs at a 4- and an 8-byte offset, aliased and separate u and g, a
    threshold tied with an element, a denormal and a zero threshold, and
    +-0, denormals, +-inf and NaN in u and g; 16 rows of the
    4,718,592-element leaf.  4a and 4b: values within an ulp of a float32
    halfway point (where a double rounding errs), IEEE corner cases, every
    operand form (a float, a (B, 1) column, full contiguous and full
    strided views) on a small arena whose rows start at every offset modulo
    16 bytes, and the main path's shapes: the eight leaf views of phase B's
    (1, total) arena and of phase C's (16, total) one (row stride total, the
    specials planted), as the accumulate, the repair's epilogue and GD's
    residual take them, and DGC's residual over the whole (16, total)
    arena.  Then timed: kernel 4 at the leaf and at 16 rows, 4a and 4b on
    the eight leaves of phase B's arena (one event's calls) and at the
    leaf, beside torch.addcmul (whether its bits match is reported as
    information: the port does not use it)."""
    from repro_torch.arith import fma
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import samomentum_kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    m, lr = 0.7, 0.05

    def check(name, got, want, quiet=False):
        compare(name, got, want, quiet=quiet, nan_as_one=True)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def plant(x):
        """+-0, denormals, +-inf and NaN, in place on a flat tensor."""
        x[1::17], x[2::17], x[3::17], x[4::17] = 0.0, -0.0, 1e-41, -3e-39
        x[5::97], x[6::97] = float("inf"), float("-inf")
        x[7::193] = float("nan")
        return x

    def cuda(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in arrays]

    # kernel 4
    for n_row in (10, 2049, 2304):
        rows = 3
        u, g = plant(randn(rows * n_row)), plant(randn(rows * n_row))
        uacc = fma(m, u, lr * g).view(rows, n_row)
        thr = torch.stack([uacc[0, n_row // 3].abs(),
                           torch.tensor(1e-41, device="cuda"),
                           torch.tensor(0.0, device="cuda")])
        for label, uu, gg, lr_ in (("u, g", u, g, lr), ("u, u", u, u, 1 - m)):
            want = sk.samomentum_plain(uu.view(rows, -1), gg.view(rows, -1),
                                       thr[:, None], momentum=m, lr=lr_)
            check(f"samomentum_fused/{rows} rows of {n_row}, {label}",
                    sk.samomentum_fused_flat(uu, gg, thr, momentum=m, lr=lr_),
                    tuple(t.reshape(-1) for t in want), quiet=True)
            for off in (1, 2):          # a 4- and an 8-byte offset
                buf = torch.empty(2, rows * n_row + off, device="cuda")
                buf[0, off:], buf[1, off:] = uu, gg
                check(f"samomentum_fused/{n_row}, {label}, offset {off}",
                        sk.samomentum_fused_flat(buf[0, off:], buf[1, off:],
                                                 thr, momentum=m, lr=lr_),
                        sk.samomentum_fused_flat(uu, gg, thr, momentum=m,
                                                 lr=lr_), quiet=True)
    log("  samomentum_fused: rows of 10, 2049, 2304 (ties, specials, "
        "aliased and separate, 0/4/8-byte offsets) bit-equal")
    n2, B = 2304 * 2048, 16
    u2 = fma(m, randn(B, n2), lr * randn(B, n2))
    u2[:, ::7] = 0.5
    thr2 = u2[:, 777].abs().contiguous()   # one element per row sits on it
    check("samomentum_fused/16 rows of the leaf, one threshold per row",
            ops.samomentum_fused_rows(u2, u2, thr2, momentum=m, lr=1.0 - m),
            sk.samomentum_plain(u2, u2, thr2[:, None], momentum=m,
                                lr=1.0 - m))
    u, g = randn(n2), randn(n2)
    uacc = fma(m, u, lr * g)
    thr = uacc[12345].abs().reshape(1)     # one element sits exactly on it
    for label, uu, gg, lr_ in (("u, g", u, g, lr),
                               ("uacc, uacc", uacc, uacc, 1.0 - m)):
        check(f"samomentum_fused/the leaf, ({label})",
                sk.samomentum_fused_flat(uu, gg, thr, momentum=m, lr=lr_),
                sk.samomentum_plain(uu, gg, thr, momentum=m, lr=lr_))
    del u, g
    o1, o2 = torch.empty_like(uacc), torch.empty_like(uacc)
    t = dict(
        ms=timer(lambda: sk.samomentum_fused_flat(uacc, uacc, thr, momentum=m,
                                                  lr=1.0 - m)),
        launch_ms=timer(lambda: build.library().samomentum_fused(
            uacc.data_ptr(), uacc.data_ptr(), thr.data_ptr(), o1.data_ptr(),
            o2.data_ptr(), m, 1 - m, sk.rcp(m), 1, n2, build.stream())),
        plain_ms=timer(lambda: sk.samomentum_plain(uacc, uacc, thr,
                                                   momentum=m, lr=1.0 - m)),
        rows16_ms=timer(lambda: ops.samomentum_fused_rows(
            u2, u2, thr2, momentum=m, lr=1.0 - m)))
    o1, o2 = torch.empty_like(u2), torch.empty_like(u2)
    t["rows16_launch_ms"] = timer(lambda: build.library().samomentum_fused(
        u2.data_ptr(), u2.data_ptr(), thr2.data_ptr(), o1.data_ptr(),
        o2.data_ptr(), m, 1 - m, sk.rcp(m), B, n2, build.stream()))
    del o1, o2
    # the (uacc, uacc) call reads one array: 4 bytes in, 8 out per element
    t["bound_ms"] = 12 * n2 / rate * 1e3
    t["rows16_bound_ms"] = 12 * B * n2 / rate * 1e3
    log(f"  samomentum_fused (leaf {n2}, u = g): kernel {t['ms']:.4f} ms "
        f"(launch alone {t['launch_ms']:.4f} ms), plain {t['plain_ms']:.4f} "
        f"ms, bound {t['bound_ms']:.4f} ms; 16 rows {t['rows16_ms']:.4f} ms "
        f"(launch alone {t['rows16_launch_ms']:.4f} ms), bound "
        f"{t['rows16_bound_ms']:.4f} ms")
    results.append(dict(
        name=sk.INFO.name, route="cuda", source=sk.INFO.source,
        replaces=sk.INFO.replaces, max_abs_err=errs["samomentum_fused"],
        bound_by="bytes", library_ms=None, **t))
    del u2

    # 4a and 4b: halfway points, corner cases, every operand form
    a, b, c = cuda(*halfway_cases(rng, 4096))
    sa, sb, sc = cuda(*special_cases())
    for label, ops3 in (("halfway points", (a, b, c)),
                        ("IEEE corner cases", (sa, sb, sc))):
        check(f"fma/{label}", (sk.fused_multiply_add(*ops3),),
              (sk.fused_multiply_add_plain(*ops3),))
    # the accumulate's own halfway points: m * u an odd integer in
    # [2^24, 2^25), lr * g = g of 2^-30 to 2^-60 of it
    hu, hg = cuda((rng.integers(2048, 2896, 4096) * 2 + 1.0)
                  .astype(np.float32),
                  (np.ldexp(1.0, -rng.integers(6, 36, 4096))
                   * rng.choice([-1.0, 1.0], 4096)).astype(np.float32))
    check("samomentum_accumulate/halfway points",
          (sk.velocity_accumulate(hu, hg, momentum=4097.0, lr=1.0),),
          (sk.velocity_accumulate_plain(hu, hg, momentum=4097.0, lr=1.0),))
    # strided leaf views of a (3, 7001) arena: odd row stride and offsets
    # put the rows at every offset modulo 16 bytes
    arena = [plant(randn(3 * 7001)).view(3, 7001) for _ in range(3)]
    lrs = torch.tensor([[0.05], [0.1], [1.0]], device="cuda")
    col = torch.tensor([[3.0], [-0.0], [1e-41]], device="cuda")
    for off, size in ((0, 10), (10, 2049), (2059, 2304), (4363, 2638)):
        x, y, z = (t_[:, off:off + size] for t_ in arena)
        for lr_ in (lr, lrs):
            check(f"samomentum_accumulate/leaf ({off}, {size})",
                  (sk.velocity_accumulate(x, y, momentum=m, lr=lr_),),
                  (sk.velocity_accumulate_plain(x, y, momentum=m, lr=lr_),),
                  quiet=True)
        for ops3 in ((x, y, z), (x, 1.0 / m - 1.0, z), (lrs, y, z),
                     (col, 0.25, x), (x, -0.5, 1e-12), (0.25, y, 0.0)):
            check(f"fma/leaf ({off}, {size})",
                  (sk.fused_multiply_add(*ops3),),
                  (sk.fused_multiply_add_plain(*ops3),), quiet=True)
    check("fma/(B, 1) result, the int8 scale",
          (sk.fused_multiply_add(col.abs(), sk.rcp(127.0), 1e-12),),
          (sk.fused_multiply_add_plain(col.abs(), sk.rcp(127.0), 1e-12),))
    log("  samomentum_accumulate, fma: strided leaf views at every 16-byte "
        "offset, lr a float / (B, 1), operands as floats, columns and "
        "views: bit-equal")
    del arena

    # the main path's shapes, leaves from phase B's ParamSpace: the leaf
    # views of phase C's (16, total) arena (row stride total, per-row lr,
    # specials planted), then of phase B's (1, total) one, which are timed
    space = full_width_space(torch)
    total, layout = space.total, list(zip(space.offsets, space.sizes))
    scale = 1.0 / m - 1.0
    for B in (16, 1):
        u, g = randn(B, total), randn(B, total)
        extra = [randn(B, s) for _, s in layout]    # the repair's blocks
        u_new = [randn(B, s) for _, s in layout]
        if B > 1:
            lrB = torch.rand(B, 1, generator=gen, device="cuda") * 0.1
            for x in [u, g] + extra + u_new:
                plant(x.view(-1))
        else:
            lrB = torch.full((1, 1), lr, device="cuda")
        views = [(u[:, o:o + s], g[:, o:o + s]) for o, s in layout]
        for i, ((uv, gv), ex, un) in enumerate(zip(views, extra, u_new)):
            check(f"samomentum_accumulate/({B}, total) leaf {i}",
                  (sk.velocity_accumulate(uv, gv, momentum=m, lr=lrB),),
                  (sk.velocity_accumulate_plain(uv, gv, momentum=m,
                                                lr=lrB),), quiet=True)
            for label, ops3 in (("repair epilogue", (ex, scale, un)),
                                ("GD residual", (lrB, gv, uv))):
                check(f"fma/({B}, total) leaf {i}, {label}",
                      (sk.fused_multiply_add(*ops3),),
                      (sk.fused_multiply_add_plain(*ops3),), quiet=True)
        check(f"fma/({B}, total) arena, DGC residual",
              (sk.fused_multiply_add(lrB, g, u),),
              (sk.fused_multiply_add_plain(lrB, g, u),), quiet=True)
        log(f"  samomentum_accumulate, fma: the 8 leaf views of the ({B}, "
            f"{total}) arena (accumulate, repair epilogue, GD residual) and "
            f"the whole arena (DGC residual) bit-equal")

    # timed on phase B's arena: one event's eight calls, and the leaf
    lr1 = lrB
    lrg = [lr1 * gv for _, gv in views]
    m_t, c_t = (torch.tensor(x, device="cuda") for x in (m, scale))
    leaf = max(range(len(layout)), key=lambda i: layout[i][1])
    # information only: the port does not call torch.addcmul
    lib_bits = {
        "samomentum_accumulate": all(torch.equal(
            torch.addcmul(p, uv, m_t).view(torch.int32),
            sk.velocity_accumulate(uv, gv, momentum=m, lr=lr1)
            .view(torch.int32)) for (uv, gv), p in zip(views, lrg)),
        "fma": all(torch.equal(
            torch.addcmul(un, ex, c_t).view(torch.int32),
            sk.fused_multiply_add(ex, scale, un).view(torch.int32))
            for ex, un in zip(extra, u_new))}
    out = torch.empty(layout[leaf][1], device="cuda")
    (uv, gv), ex, un = views[leaf], extra[leaf], u_new[leaf]
    for info, call, plain, lib, launch in (
            (sk.ACC_INFO,
             lambda i: sk.velocity_accumulate(*views[i], momentum=m, lr=lr1),
             lambda i: sk.velocity_accumulate_plain(*views[i], momentum=m,
                                                    lr=lr1),
             lambda i: torch.addcmul(lrg[i], views[i][0], m_t),
             lambda: build.library().samomentum_accumulate(
                 uv.data_ptr(), total, gv.data_ptr(), total, lr1.data_ptr(),
                 0, 0.0, out.data_ptr(), m, 1, uv.shape[1],
                 build.stream())),
            (sk.FMA_INFO,
             lambda i: sk.fused_multiply_add(extra[i], scale, u_new[i]),
             lambda i: sk.fused_multiply_add_plain(extra[i], scale, u_new[i]),
             lambda i: torch.addcmul(u_new[i], extra[i], c_t),
             lambda: build.library().fma_rows(
                 ex.data_ptr(), ex.shape[1], 0.0, sk.FULL, None, 0, scale,
                 sk.SCALAR, un.data_ptr(), un.shape[1], 0.0, sk.FULL,
                 out.data_ptr(), 1, ex.shape[1], build.stream()))):
        every = range(len(layout))
        t = dict(
            ms=timer(lambda: [call(i) for i in every]),
            plain_ms=timer(lambda: [plain(i) for i in every]),
            library_ms=timer(lambda: [lib(i) for i in every]),
            bound_ms=12 * total / rate * 1e3,
            leaf_ms=timer(lambda: call(leaf)),
            leaf_launch_ms=timer(launch),
            leaf_plain_ms=timer(lambda: plain(leaf)),
            leaf_library_ms=timer(lambda: lib(leaf)),
            leaf_bound_ms=12 * layout[leaf][1] / rate * 1e3,
            library_bits_equal=lib_bits[info.name],
            host_us=host_us(torch, lambda: call(leaf)))
        log(f"  {info.name} (8 leaves, {total} elements, one event's calls):"
            f" kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"addcmul {t['library_ms']:.4f} ms (bits equal, for information: "
            f"{t['library_bits_equal']}), bound {t['bound_ms']:.4f} ms; leaf "
            f"{layout[leaf][1]}: kernel {t['leaf_ms']:.4f} ms (launch alone "
            f"{t['leaf_launch_ms']:.4f} ms), plain {t['leaf_plain_ms']:.4f} "
            f"ms, addcmul {t['leaf_library_ms']:.4f} ms, bound "
            f"{t['leaf_bound_ms']:.4f} ms; host per call {t['host_us']:.1f} "
            f"us")
        results.append(dict(
            name=info.name, route="cuda", source=info.source,
            replaces=info.replaces, max_abs_err=errs[info.name],
            bound_by="bytes", **t))


def scatter_rows_kernel(torch, timer, rate, results, compare, errs):
    """Kernel 2, the multi-row scatter-add, against its plain version bit
    for bit at the batched commit's shapes: 16 permuted rows of the
    (100, 10,512,650) ``v``, k = 10,514 per lane, one adversarial case per
    lane (all updates on one index; all in one CTA's range, so several
    rounds of ``ROUND``; duplicates across round boundaries; out-of-range
    and negative indices; zero values on -0 words; planted duplicates),
    the same lanes one at a time (B = 1), the same with the row ids in
    device memory (the scan runner's commit) against the host table and
    the plain version, device rows out of range, the identity rows, k = 0,
    and 600 lanes (two launches).  Timed at 16 rows, at the serial and
    scan commit's B = 1 (a device row of ``v``) and at the blockwise
    repair's B = 1 (1 x 4,718,592, k = 4,719, identity rows)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import scatter_apply as sa

    gen = torch.Generator(device="cuda").manual_seed(11)
    n, k, n_rows, B = 10_512_650, 10_514, 100, 16
    rows = np.random.default_rng(4).permutation(n_rows)[:B]
    dense2d = torch.randn(n_rows, n, generator=gen, device="cuda")
    idx2d = torch.stack([torch.randperm(n, generator=gen, device="cuda")[:k]
                         for _ in range(B)]).to(torch.int32)
    vals2d = torch.randn(B, k, generator=gen, device="cuda")
    unique = idx2d.clone()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = -(-n // (sms // B))                 # one CTA's range at B = 16

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device="cuda",
                             dtype=torch.int32)

    adv = idx2d.clone()
    adv[1] = 4242                                   # all on one index
    adv[2] = ints(w, w + min(w, 3000), k)           # all in CTA 1's range
    last = (-(-n // w) - 1) * w                     # the last CTA's range
    adv[3] = ints(last, n, k)                       # across round boundaries
    for j in range(1, k // sa.ROUND + 1):
        adv[3, j * sa.ROUND - 1:j * sa.ROUND + 1] = n - 7
    ar = torch.arange(0, k, 5, device="cuda", dtype=torch.int32)
    adv[4, ::5] = n + ar                            # out of range
    adv[4, 2::5] = -1 - ar[:adv[4, 2::5].numel()]
    adv[4, 3], adv[4, 4], adv[4, 8] = 2**31 - 1, -2**31, n
    adv[6, ::5] = adv[6, 0]                         # planted duplicates
    adv[6, 1::7] = 99
    avals = vals2d.clone()
    avals[5, :100] = 0.0                            # zeros on -0 words ...
    avals[5, 100:150] = -0.0
    dense2d[int(rows[5]), adv[5, :150].long()] = -0.0
    avals[5, 150:160] = 0.0                         # ... and a +0 pad on one
    adv[5, 150:160] = adv[5, 0]
    for label, ii, vv in (("one case per lane", adv, avals),
                          ("unique", unique, vals2d)):
        a = sa.scatter_add_rows_(dense2d.clone(), rows, ii, vv)
        b = sa.scatter_add_rows_plain(dense2d.clone(), rows, ii, vv)
        compare(f"scatter_add_rows/16 permuted rows, {label}", (a,), (b,))
        del a, b
    for lane in range(8):                           # each case at B = 1
        r = [int(rows[lane])]
        a = sa.scatter_add_rows_(dense2d.clone(), r, adv[lane:lane + 1],
                                 avals[lane:lane + 1])
        b = sa.scatter_add_rows_plain(dense2d.clone(), r, adv[lane:lane + 1],
                                      avals[lane:lane + 1])
        compare(f"scatter_add_rows/B = 1, lane {lane}", (a,), (b,),
                quiet=True)
        del a, b
    log("  scatter_add_rows: each lane's case at B = 1 bit-equal")
    # device row ids (the scan runner's commit: this event's worker id in
    # device memory), held to the host-table launch and the plain version
    rows_t = torch.from_numpy(rows.astype(np.int64)).cuda()
    a = sa.scatter_add_rows_(dense2d.clone(), rows_t, adv, avals)
    compare("scatter_add_rows/16 device rows against the host table", (a,),
            (sa.scatter_add_rows_(dense2d.clone(), rows, adv, avals),))
    compare("scatter_add_rows/16 device rows against the plain version",
            (a,), (sa.scatter_add_rows_plain(dense2d.clone(), rows_t, adv,
                                             avals),))
    del a
    for lane in range(8):                           # the commit's B = 1
        r = rows_t[lane:lane + 1]
        a = sa.scatter_add_rows_(dense2d.clone(), r, adv[lane:lane + 1],
                                 avals[lane:lane + 1])
        b = sa.scatter_add_rows_(dense2d.clone(), [int(rows[lane])],
                                 adv[lane:lane + 1], avals[lane:lane + 1])
        compare(f"scatter_add_rows/device row, B = 1, lane {lane}", (a,),
                (b,), quiet=True)
        del a, b
    log("  scatter_add_rows: device row ids, each lane at B = 1, bit-equal "
        "to the host table")
    bad = torch.tensor([n_rows, -1], dtype=torch.int64, device="cuda")
    compare("scatter_add_rows/device rows out of range write nothing",
            (sa.scatter_add_rows_(dense2d[:4].clone(), bad, adv[:2],
                                  avals[:2]),), (dense2d[:4],))
    head = dense2d[:B]                              # identity rows 0..15
    compare("scatter_add_rows/identity rows",
            (sa.scatter_add_rows_(head.clone(), None, adv, avals),),
            (sa.scatter_add_rows_plain(head.clone(), None, adv, avals),))
    two = torch.from_numpy(rows[:2]).cuda()
    before = dense2d[two].clone()
    sa.scatter_add_rows_(dense2d, rows[:2], adv[:2, :0], avals[:2, :0])
    compare("scatter_add_rows/k=0", (dense2d[two],), (before,))
    small = torch.randn(700, 5000, generator=gen, device="cuda")
    many = np.random.default_rng(5).permutation(700)[:600]
    mi = torch.randint(-5, 5005, (600, 37), generator=gen, device="cuda",
                       dtype=torch.int32)
    mv = torch.randn(600, 37, generator=gen, device="cuda")
    compare("scatter_add_rows/600 lanes (two launches)",
            (sa.scatter_add_rows_(small.clone(), many, mi, mv),),
            (sa.scatter_add_rows_plain(small.clone(), many, mi, mv),))
    del small, head, before

    # timed on the unique indices of the main path (top-k supports)
    sel = torch.from_numpy(rows).cuda()
    rows_dev = sel[:, None].expand(B, k)
    idx64 = unique.to(torch.int64)
    table = (ctypes.c_int32 * B)(*rows.tolist())
    t = dict(
        ms=timer(lambda: sa.scatter_add_rows_(dense2d, rows, unique, vals2d)),
        launch_ms=timer(lambda: build.library().scatter_add_rows(
            dense2d.data_ptr(), n, table, None, n_rows, B, unique.data_ptr(),
            vals2d.data_ptr(), k, build.stream())),
        plain_ms=timer(lambda: sa.scatter_add_rows_plain(
            dense2d, rows, unique, vals2d)),
        library_ms=timer(lambda: dense2d.index_put_((rows_dev, idx64), vals2d,
                                                    accumulate=True)),
        # B*k indices + B*k values read, B*k target words read and written
        bound_ms=B * k * (4 + 4 + 8) / rate * 1e3,
        host_us=host_us(torch, lambda: sa.scatter_add_rows_(
            dense2d, rows, unique, vals2d)))
    # the commit's call: one lane on a device row of the (100, n) v
    r0, i0, v0 = rows_t[:1], unique[:1], vals2d[:1]
    t.update(
        commit_ms=timer(lambda: sa.scatter_add_rows_(dense2d, r0, i0, v0)),
        commit_host_ms=timer(lambda: sa.scatter_add_rows_(
            dense2d, [int(rows[0])], i0, v0)),
        commit_bound_ms=k * 16 / rate * 1e3,
        commit_host_us=host_us(torch, lambda: sa.scatter_add_rows_(
            dense2d, r0, i0, v0)))
    log(f"  scatter_add_rows commit (device row of the ({n_rows}, {n}) v, "
        f"k={k}): {t['commit_ms']:.4f} ms (host-table row "
        f"{t['commit_host_ms']:.4f} ms), bound {t['commit_bound_ms']:.5f} "
        f"ms; host per call {t['commit_host_us']:.1f} us")
    del dense2d
    # the blockwise repair's call: one lane, identity rows
    n1, k1 = 2304 * 2048, 4719
    d1 = torch.randn(1, n1, generator=gen, device="cuda")
    i1 = torch.randperm(n1, generator=gen, device="cuda")[:k1].to(
        torch.int32)[None]
    v1 = torch.randn(1, k1, generator=gen, device="cuda")
    zero_rows = torch.zeros((1, k1), dtype=torch.int64, device="cuda")
    i1_64 = i1.to(torch.int64)
    t.update(
        b1_ms=timer(lambda: sa.scatter_add_rows_(d1, None, i1, v1)),
        b1_launch_ms=timer(lambda: build.library().scatter_add_rows(
            d1.data_ptr(), n1, None, None, 1, 1, i1.data_ptr(), v1.data_ptr(),
            k1, build.stream())),
        b1_plain_ms=timer(lambda: sa.scatter_add_rows_plain(d1, None, i1,
                                                            v1)),
        b1_library_ms=timer(lambda: d1.index_put_((zero_rows, i1_64), v1,
                                                  accumulate=True)),
        b1_bound_ms=k1 * 16 / rate * 1e3,
        b1_host_us=host_us(torch, lambda: sa.scatter_add_rows_(d1, None, i1,
                                                               v1)))
    log(f"  scatter_add_rows ({B} rows, k={k}): wrapper {t['ms']:.4f} ms "
        f"(launch alone {t['launch_ms']:.4f} ms), plain {t['plain_ms']:.4f} "
        f"ms, index_put_ {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.5f} ms; host per call {t['host_us']:.1f} us")
    log(f"  scatter_add_rows B=1 (1 x {n1}, k={k1}, identity rows): wrapper "
        f"{t['b1_ms']:.4f} ms (launch alone {t['b1_launch_ms']:.4f} ms), "
        f"plain {t['b1_plain_ms']:.4f} ms, index_put_ "
        f"{t['b1_library_ms']:.4f} ms, bound {t['b1_bound_ms']:.5f} ms; host "
        f"per call {t['b1_host_us']:.1f} us")
    results.append(dict(
        name=sa.ROWS_INFO.name, route="cuda", source=sa.ROWS_INFO.source,
        replaces=sa.ROWS_INFO.replaces, max_abs_err=errs["scatter_add_rows"],
        bound_by="bytes", **t))


def h_kernels(torch, timer, rate, results, compare):
    """Rows 2, 3, 4, 4a and 4b at phase H1's shapes, bit for bit against
    their plain versions (every NaN as one where the kernel computes).
    H1's largest leaf as the exchange cuts it (chatglm3-6b's embedding:
    (65,024, 4,096) rows, k_row 205) through one worker's blockwise step:
    the accumulate (4a), the block top-r (3: r = 205 over the 520,192
    blocks of the rows padded to whole groups of 8 blocks, as the
    hierarchy launches it, adversarial blocks planted in its first rows;
    the selection itself takes the row regime, 3r, held by row_kernels),
    the fused pass at each row's threshold (4), the repair's
    scatter-add (2: 65,024 lanes, 127 launches of 512) and its fma (4b).
    Then row 2 at the exchange's other launches on that leaf: allgather's
    union (W * k_row entries a row, a worker's indices repeated so that
    duplicates add in update order), shardedps's receive into the W lanes'
    M shards (W * 65,024 lanes of shard_rest, W * cap slots, a third of
    them -1, +-0 values) and its downward scatter (W * k2 a row); and row 3
    at r = 410 on the MLP leaves' (13,696, 8,192) view.  Timed at the
    embedding: rows 3, 4, 4a, 4b and the repair."""
    from repro_torch.core.distributed import leaf_cut
    from repro_torch.core.engine import BlockwiseEngine
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import ops
    from repro_torch.kernels import samomentum_kernel as sk
    from repro_torch.kernels import scatter_apply as sa
    from repro_torch.launch.sharding import shard_axis_hints
    from repro_torch.models.model import abstract_params

    cfg = _h_cfg(H_LAYERS)
    ab = abstract_params(cfg)
    cuts = {}
    for p, ax in zip(tree_leaves(ab), shard_axis_hints(cfg, ab, 1)):
        for mode in ("allgather", "shardedps"):
            cuts.setdefault(mode, []).append(
                (p.numel(), leaf_cut(p.shape, ax, _h_exchange(mode), H_W)))
    c = max(cuts["allgather"], key=lambda x: x[0])[1]
    cs = max(cuts["shardedps"], key=lambda x: x[0])[1]
    S, rest, k_row, W = c.S, c.rest, c.k_row, H_W
    eng = BlockwiseEngine()
    r = eng._plan(rest, k_row)
    m, lr = H_MOMENTUM, H_LR
    gen = torch.Generator(device="cuda").manual_seed(23)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def check(name, got, want):
        compare(name, got, want, nan_as_one=True)

    tag = f"H1 leaf ({S}, {rest})"
    u, g = randn(S, rest) * 0.01, randn(S, rest)
    uacc = sk.velocity_accumulate(u, g, momentum=m, lr=lr)
    check(f"samomentum_accumulate/{tag}", (uacc,),
          (sk.velocity_accumulate_plain(u, g, momentum=m, lr=lr),))
    plant_blocks(torch, gen, uacc.view(-1, bt.BLOCK))
    # the launch the hierarchy makes: each row zero-padded to whole groups
    # of GROUP blocks
    blocks = torch.nn.functional.pad(
        uacc, (0, (-rest) % (bt.BLOCK * bt.GROUP))).view(-1, bt.BLOCK)
    check(f"block_topk/{tag}, {blocks.shape[0]} blocks, r={r}",
          bt.block_topk_2d(blocks, r=r), bt.block_topk_plain(blocks, r))
    vals, idx = eng.select_rows(uacc, k_row)
    thr = vals.abs().amin(dim=1)
    sent, u_new = ops.samomentum_fused_rows(uacc, uacc, thr, momentum=m,
                                            lr=1.0 - m)
    check(f"samomentum_fused/{tag}, k_row={k_row}", (sent, u_new),
          sk.samomentum_plain(uacc, uacc, thr[:, None], momentum=m,
                              lr=1.0 - m))
    extra = sa.scatter_add_rows_(sent.clone(), None, idx, -vals)
    check(f"scatter_add_rows/{tag}, the repair ({S} lanes of {k_row})",
          (extra,), (sa.scatter_add_rows_plain(sent.clone(), None, idx,
                                               -vals),))
    check(f"fma/{tag}, the repair epilogue",
          (sk.fused_multiply_add(extra, 1.0 / m - 1.0, u_new),),
          (sk.fused_multiply_add_plain(extra, 1.0 / m - 1.0, u_new),))
    t = dict(
        ms=timer(lambda: bt.block_topk_2d(blocks, r=r), reps=5),
        bound_ms=(4 * blocks.numel() + 8 * blocks.shape[0] * r) / rate * 1e3)
    next(x for x in results if x["name"] == bt.INFO.name).update(
        {f"h1_{key}": val for key, val in t.items()})
    times = {
        sk.INFO.name: (lambda: ops.samomentum_fused_rows(
            uacc, uacc, thr, momentum=m, lr=1.0 - m), 12 * uacc.numel()),
        sk.ACC_INFO.name: (lambda: sk.velocity_accumulate(
            u, g, momentum=m, lr=lr), 12 * uacc.numel()),
        sk.FMA_INFO.name: (lambda: sk.fused_multiply_add(
            extra, 1.0 / m - 1.0, u_new), 12 * uacc.numel()),
        sa.ROWS_INFO.name: (lambda: sa.scatter_add_rows_(
            extra, None, idx, vals), 16 * idx.numel())}
    for name, (fn, nbytes) in times.items():
        row = next(x for x in results if x["name"] == name)
        row.update(h1_ms=timer(fn, reps=5), h1_bound_ms=nbytes / rate * 1e3)
        log(f"  {name} at the {tag}: {row['h1_ms']:.4f} ms, bound "
            f"{row['h1_bound_ms']:.4f} ms")
    log(f"  block_topk at the {tag}, r={r}: {t['ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms")
    del u, g, uacc, blocks, sent, u_new, extra, vals

    # row 2 at the exchange's other launches on the leaf
    gi = torch.cat([idx, idx.roll(1, 0), idx.flip(0), idx], dim=1)
    gv = randn(*gi.shape)
    gv[:, ::13] = -0.0
    dense = torch.zeros(S, rest, device="cuda")
    check(f"scatter_add_rows/{tag}, the allgather union ({W} x {k_row} a "
          f"row)", (sa.scatter_add_rows_(dense.clone(), None, gi, gv),),
          (sa.scatter_add_rows_plain(dense.clone(), None, gi, gv),))
    del gi, gv, dense, idx
    sr, cap, k2 = cs.shard_rest, cs.cap, cs.k2
    M = randn(W * S, sr)
    ri = torch.randint(0, sr, (W * S, W * cap), generator=gen,
                       device="cuda", dtype=torch.int32)
    ri[:, ::3] = -1
    rv = randn(W * S, W * cap)
    rv[:, 1::7] = -0.0
    M[:, ::11] = -0.0
    check(f"scatter_add_rows/{tag}, the shardedps receive ({W * S} lanes "
          f"of {sr}, {W * cap} slots)",
          (sa.scatter_add_rows_(M.clone(), None, ri, rv),),
          (sa.scatter_add_rows_plain(M.clone(), None, ri, rv),))
    del M, ri, rv
    di = torch.randint(0, W * sr, (S, W * k2), generator=gen, device="cuda",
                       dtype=torch.int32)
    dv = randn(S, W * k2)
    dense = torch.zeros(S, W * sr, device="cuda")
    check(f"scatter_add_rows/{tag}, the shardedps downward ({W} x {k2} a "
          f"row)", (sa.scatter_add_rows_(dense.clone(), None, di, dv),),
          (sa.scatter_add_rows_plain(dense.clone(), None, di, dv),))
    del di, dv, dense
    # row 3 at the MLP leaves' view
    c2 = max((x for _, x in cuts["allgather"] if x.S < S),
             key=lambda x: x.S * x.rest)
    r2 = eng._plan(c2.rest, c2.k_row)
    x = randn(c2.S * c2.rest // bt.BLOCK, bt.BLOCK)
    plant_blocks(torch, gen, x)
    check(f"block_topk/H1 leaf ({c2.S}, {c2.rest}), r={r2}",
          bt.block_topk_2d(x, r=r2), bt.block_topk_plain(x, r2))
    del x
    torch.cuda.empty_cache()


# the row regime at the benchmark cells' row shapes (S, n, k): chatglm3's
# embedding and lm_head rows and its MLP leaves' view, minicpm3's shortest
# and longest hinted rows, and a (2, 1,024) downward top-k2 of shardedps
ROW_CELLS = ((65024, 4096, 205), (13696, 8192, 410), (5120, 512, 26),
             (6400, 5120, 256), (2, 1024, 51))
# (n, ks) of the edge cases: k = 1, around kSelectMaxR, above a block, k =
# n; n not a multiple of 32 or of 4 (the scalar loads), n = ROW_MAX
ROW_EDGES = ((4096, (1, 64, 65, 1500, 4096)), (1000, (1, 33, 999, 1000)),
             (37, (1, 5, 37)), (8192, (1, 410, 8192)))


def plant_rows(torch, gen, x2d):
    """Adversarial rows for the row top-k, in place on rows 0-8 of
    ``(S, n)``: all zero, zeros of both signs, two values of opposite sign
    (ties at every rank), denormals of both signs, NaN among normals,
    infinities of both signs, small integers, mostly zero with normals and
    denormals, and planted ties around a 5% boundary."""
    S, n = x2d.shape
    dev = x2d.device

    def normal(size=n):
        return torch.randn(size, generator=gen, device=dev)

    sign = torch.where(normal() > 0, 1.0, -1.0)
    tiny = torch.tensor(1e-41, device=dev)        # below 2**-126
    rows = [torch.zeros(n, device=dev), 0.0 * sign, 0.25 * sign,
            torch.randint(1, 9, (n,), generator=gen,
                          device=dev).float() * tiny * sign]
    b = normal()
    b[::17] = float("nan")
    rows.append(b)
    b = normal()
    b[::13], b[1::13] = float("inf"), float("-inf")
    rows.append(b)
    rows.append(torch.round(normal() * 2))
    b = torch.zeros(n, device=dev)
    b[::50] = normal(len(range(0, n, 50)))
    b[7::33] = tiny * sign[7::33]
    rows.append(b)
    b = normal()
    b[b.abs() > 1.6] = 2.0 * torch.sign(b[b.abs() > 1.6])
    rows.append(b)
    for i, row in enumerate(rows[:S]):
        x2d[i] = row


def row_kernels(torch, timer, rate, results, compare, errs):
    """The row regime of row 3 (``row_topk``), bit for bit against its
    plain version and against the hierarchy it replaces
    (``hierarchical_topk_rows`` at r = k), at the cells' row shapes with
    adversarial rows planted, at the edge cases, at a 4-byte offset (the
    scalar loads) and on strided rows; the engine's dispatch at ROW_MAX
    and ROW_MAX + 1 by the launch counters.  Timed at every cell shape:
    kernel, launch alone, plain version, ``torch.topk`` of |x| and the
    hierarchy, beside the bound (the row read once, k values and indices
    written)."""
    from repro_torch.core.engine import BlockwiseEngine
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import build, ops

    gen = torch.Generator(device="cuda").manual_seed(30)

    def three(name, x2d, k, want=None):
        got = bt.row_topk_rows(x2d, k)
        compare(f"row_topk/{name}", got,
                want if want is not None else bt.row_topk_plain(x2d, k),
                quiet=True)
        compare(f"row_topk/{name} vs the hierarchy", got,
                ops.hierarchical_topk_rows(x2d, k=k, r=k), quiet=True)

    for n, ks in ROW_EDGES:
        x = torch.randn(12, n, generator=gen, device="cuda")
        plant_rows(torch, gen, x)
        # the same rows at a 4-byte offset, and as strided rows of a wider
        # tensor (a leaf's view of a batch of arenas)
        shifted = torch.empty(12 * n + 1, device="cuda")
        shifted[1:] = x.reshape(-1)
        wide = torch.zeros(12, n + 7, device="cuda")
        wide[:, 3:3 + n] = x
        for k in ks:
            want = bt.row_topk_plain(x, k)
            three(f"({12}, {n}), k={k}", x, k)
            three(f"({12}, {n}), k={k}, 4-byte offset",
                  shifted[1:].view(12, n), k, want)
            three(f"({12}, {n}), k={k}, strided rows", wide[:, 3:3 + n], k,
                  want)
        log(f"  row_topk: n={n}, k in {ks}: bit-equal to the plain version "
            f"and the hierarchy, also at a 4-byte offset and strided")
        del x, shifted, wide
    timings = {}
    for S, n, k in ROW_CELLS:
        x = torch.randn(S, n, generator=gen, device="cuda")
        plant_rows(torch, gen, x)
        three(f"({S}, {n}), k={k}", x, k)
        vals_o = torch.empty((S, k), device="cuda")
        idx_o = torch.empty((S, k), dtype=torch.int32, device="cuda")
        reps = 5 if S * n > 1 << 24 else 15
        t = timings[(S, n, k)] = dict(
            ms=timer(lambda: bt.row_topk_rows(x, k), reps=reps),
            launch_ms=timer(lambda: build.library().row_topk(
                x.data_ptr(), n, vals_o.data_ptr(), idx_o.data_ptr(), S, n,
                k, build.stream()), reps=reps),
            plain_ms=timer(lambda: bt.row_topk_plain(x, k), reps=reps),
            library_ms=timer(lambda: torch.topk(x.abs(), k, dim=1),
                             reps=reps),
            hierarchy_ms=timer(lambda: ops.hierarchical_topk_rows(
                x, k=k, r=k), reps=reps),
            bound_ms=(4 * S * n + 8 * S * k) / rate * 1e3)
        t["zero_rows_ms"] = None
        if S > 10_000:      # the embedding early on: rows of absent tokens
            x.zero_()
            x[::32] = torch.randn(len(range(0, S, 32)), n, generator=gen,
                                  device="cuda")
            three(f"({S}, {n}), k={k}, 31 of 32 rows zero", x, k)
            t["zero_rows_ms"] = timer(lambda: bt.row_topk_rows(x, k),
                                      reps=reps)
        host = host_us(torch, lambda: bt.row_topk_rows(x, k), calls=20)
        log(f"  row_topk ({S}, {n}), k={k}: kernel {t['ms']:.4f} ms "
            f"(launch alone {t['launch_ms']:.4f} ms; 31 of 32 rows zero "
            f"{t['zero_rows_ms']} ms), plain {t['plain_ms']:.4f} ms, "
            f"torch.topk {t['library_ms']:.4f} ms, the hierarchy "
            f"{t['hierarchy_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['ms'] / t['bound_ms']:.2f}x); host per call {host:.1f} us")
        del x, vals_o, idx_o
        torch.cuda.empty_cache()

    # the dispatch: ROW_MAX takes the row regime, ROW_MAX + 1 the hierarchy
    eng = BlockwiseEngine()
    for n, want in ((bt.ROW_MAX, (1, 0)), (bt.ROW_MAX + 1, (0, 1))):
        x = torch.randn(3, n, generator=gen, device="cuda")
        before = (bt.ROW_INFO.launches, bt.INFO.launches)
        got = eng.select_rows(x, 410)
        made = (bt.ROW_INFO.launches - before[0],
                bt.INFO.launches - before[1])
        if made != want:
            raise AssertionError(f"row_topk: n={n} launched (row, block) "
                                 f"{made}, expected {want}")
        compare(f"row_topk/engine at n={n}", got,
                bt.row_topk_plain(x, 410), quiet=True)
    log(f"  row_topk: the engine takes the row regime at n = {bt.ROW_MAX} "
        f"and the hierarchy at {bt.ROW_MAX + 1}")
    emb = timings[ROW_CELLS[0]]
    results.append(dict(
        name=bt.ROW_INFO.name, route="cuda", source=bt.ROW_INFO.source,
        replaces=bt.ROW_INFO.replaces, max_abs_err=errs["row_topk"],
        ms=emb["ms"], plain_ms=emb["plain_ms"], bound_ms=emb["bound_ms"],
        bound_by="bytes", library_ms=emb["library_ms"],
        launch_ms=emb["launch_ms"],
        cells={f"{S}x{n}/k{k}": t for (S, n, k), t in timings.items()}))


def sam_row_kernels(torch, timer, rate, results, compare, errs):
    """The row-wise SAMomentum step in one pass (``samomentum_row_topk``),
    bit for bit in values, indices and the new velocity against its plain
    version on the same inputs (the float64-emulated accumulate, the plain
    row top-k, the mask rescale: NaNs read as one pattern, as for row 4a)
    and against the chain it replaces on the card (row 4a's accumulate,
    row 3r's ``row_topk``, the support mask and the rescale), out of place
    and in place over u: at the allgather cells' row shapes (``ROW_CELLS``'
    first four: chatglm3's embedding and lm_head rows, its MLP leaves'
    view, minicpm3's shortest hinted rows and its MLP rows) with tie-heavy
    rows planted (u's adversarial rows under g = 0, g's under u = 0), at
    the edges (k = n, n odd, a row of 2), at another lr, at a 4-byte
    offset and on strided rows.  Timed at every cell shape as the exchange
    calls it (in place): kernel, launch alone, the chain, rows 4a and 3r
    alone, the plain version, beside the bound (u and g read once, u
    written once, k values and indices a row)."""
    from repro_torch.core import engine
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import build, samomentum_kernel
    from repro_torch.arith import rcp

    m, lr0 = H_MOMENTUM, H_LR
    gen = torch.Generator(device="cuda").manual_seed(33)

    def chain(u, g, lr, k):
        uacc = samomentum_kernel.velocity_accumulate(u, g, momentum=m,
                                                     lr=lr)
        vals, idx = bt.row_topk_rows(uacc, k)
        mask = engine.rows_support_mask(idx, uacc.shape[1])
        return vals, idx, engine.samomentum_rescale(uacc, mask, m)

    def planted(S, n):
        u = torch.randn(S, n, generator=gen, device="cuda")
        g = torch.randn(S, n, generator=gen, device="cuda")
        h = min(S, 18)
        plant_rows(torch, gen, u[:h])
        g[:9] = 0.0
        plant_rows(torch, gen, g[9:h])
        u[9:h] = 0.0
        return u, g

    def check(name, u, g, k, lr=lr0):
        plain = bt.samomentum_row_topk_plain(u, g, momentum=m, lr=lr, k=k)
        want = chain(u, g, lr, k)
        got = bt.samomentum_row_topk_rows(u, g, momentum=m, lr=lr, k=k)
        compare(f"samomentum_row_topk/{name}", got, plain, quiet=True,
                nan_as_one=True)
        compare(f"samomentum_row_topk_chain/{name}", got, want, quiet=True)
        mine = u.clone()
        got = bt.samomentum_row_topk_rows(mine, g, momentum=m, lr=lr, k=k,
                                          out=mine)
        compare(f"samomentum_row_topk/{name}, in place", got, plain,
                quiet=True, nan_as_one=True)
        compare(f"samomentum_row_topk_chain/{name}, in place", got, want,
                quiet=True)
        del plain, want, got, mine

    for S, n, ks in ((12, 4096, (1, 205, 4096)), (20, 1001, (1, 50, 1001)),
                     (20, 37, (5, 37)), (300, 2, (1, 2)),
                     (20, 8192, (410, 8192))):
        u, g = planted(S, n)
        shifted = torch.zeros(2, S * n + 1, device="cuda")
        shifted[0, 1:], shifted[1, 1:] = u.reshape(-1), g.reshape(-1)
        wide = torch.zeros(2, S, n + 7, device="cuda")
        wide[0, :, 3:3 + n], wide[1, :, 3:3 + n] = u, g
        for k in ks:
            check(f"({S}, {n}), k={k}", u, g, k)
            check(f"({S}, {n}), k={k}, lr 0.0371", u, g, k, 0.0371)
            check(f"({S}, {n}), k={k}, 4-byte offset",
                  shifted[0, 1:].view(S, n), shifted[1, 1:].view(S, n), k)
            check(f"({S}, {n}), k={k}, strided rows", wide[0, :, 3:3 + n],
                  wide[1, :, 3:3 + n], k, 0.0371)
        del u, g, shifted, wide
    log("  samomentum_row_topk: bit-equal to its plain version and to the "
        "chain (4a, 3r, mask, rescale) at the edges, at two lr, at a 4-byte "
        "offset, strided and in place")
    timings = {}
    for S, n, k in ROW_CELLS[:4]:
        u, g = planted(S, n)
        check(f"({S}, {n}), k={k}", u, g, k)
        vals_o = torch.empty((S, k), device="cuda")
        idx_o = torch.empty((S, k), dtype=torch.int32, device="cuda")
        reps = 5 if S * n > 1 << 24 else 15

        def fused():
            return bt.samomentum_row_topk_rows(u, g, momentum=m,
                                               lr=lr0, k=k, out=u)

        def launch():
            return build.library().samomentum_row_topk(
                u.data_ptr(), n, g.data_ptr(), n, u.data_ptr(), n, lr0, m,
                rcp(m), vals_o.data_ptr(), idx_o.data_ptr(), S, n, k,
                build.stream())

        def kernels_alone():
            uacc = samomentum_kernel.velocity_accumulate(
                u, g, momentum=m, lr=lr0)
            return bt.row_topk_rows(uacc, k)

        t = timings[(S, n, k)] = dict(
            ms=timer(fused, reps=reps), launch_ms=timer(launch, reps=reps),
            chain_ms=timer(lambda: chain(u, g, lr0, k), reps=reps),
            acc_topk_ms=timer(kernels_alone, reps=reps),
            plain_ms=timer(lambda: bt.samomentum_row_topk_plain(
                u, g, momentum=m, lr=lr0, k=k), reps=reps),
            bound_ms=(12 * S * n + 8 * S * k) / rate * 1e3)
        host = host_us(torch, fused, calls=20)
        log(f"  samomentum_row_topk ({S}, {n}), k={k}: kernel "
            f"{t['ms']:.4f} ms (launch alone {t['launch_ms']:.4f} ms), the "
            f"chain {t['chain_ms']:.4f} ms (4a + 3r alone "
            f"{t['acc_topk_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['ms'] / t['bound_ms']:.2f}x); "
            f"host per call {host:.1f} us")
        del u, g, vals_o, idx_o
        torch.cuda.empty_cache()
    emb = timings[ROW_CELLS[0]]
    results.append(dict(
        name=bt.SAM_ROW_INFO.name, route="cuda",
        source=bt.SAM_ROW_INFO.source, replaces=bt.SAM_ROW_INFO.replaces,
        max_abs_err=errs["samomentum_row_topk"], ms=emb["ms"],
        plain_ms=emb["plain_ms"], bound_ms=emb["bound_ms"],
        bound_by="bytes", library_ms=None, launch_ms=emb["launch_ms"],
        cells={f"{S}x{n}/k{k}": t for (S, n, k), t in timings.items()}))


G_SHARDS = 4        # phase G's shards: 4 of phase B's arena, one empty
G_BATCH = 16        # the coordinator's largest batch (C's max_batch)


def shard_kernels(torch, timer, rate, results, compare):
    """Rows 1 and 2 at the mesh server's shapes (phase G2), bit for bit
    against their plain versions, and timed: the flat scatter-add as the
    route exchange places a batch of 16 phase B messages (B * S = 64 chunks
    of kp = 2,629 into a zeroed (64 * (S * kp + 1),) buffer, the padding
    and the overflow to each chunk's dump slot); the multi-row one with S
    lanes on the stacked (S, width) M (the receive of one event: its
    route's -1 slots and +-0 values) and with B * S lanes on v viewed as
    (100 * S, width) (the commit of a batch).  The library yardsticks take
    the same operands, the -1 slots filtered out beforehand for
    ``index_put_``."""
    from repro_torch.core import distributed
    from repro_torch.core import server as ps
    from repro_torch.core.paramspace import ShardSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import scatter_apply as sa

    space = full_width_space(torch)
    spec = ShardSpec.for_space(space, G_SHARDS)
    S, B, W = G_SHARDS, G_BATCH, 100
    width = ps.mesh_width(spec)
    gen = torch.Generator(device="cuda").manual_seed(21)
    k = sum(space.ks(0.001))
    idx = torch.stack([torch.randperm(space.total, generator=gen,
                                      device="cuda")[:k]
                       for _ in range(B)]).to(torch.int32)
    vals = torch.randn(B, k, generator=gen, device="cuda")
    vals[:, ::9] = -0.0
    vals[:, 4::13] = 0.0
    log(f"  shard bounds {spec.bounds}, sizes {spec.sizes}, mesh width "
        f"{width}")

    # row 1: the route's placement, as shard_exchange_batch cuts the batch
    kp = ShardSpec.even_stride(k, S)
    idx3 = torch.nn.functional.pad(idx, (0, S * kp - k), value=-1).view(
        B * S, kp)
    val3 = torch.nn.functional.pad(vals, (0, S * kp - k)).view(B * S, kp)
    slots, placed, _, _ = ops.route_slots(idx3, val3, bounds=spec.bounds,
                                          n_shards=S, cap=kp)
    n_buf = B * S * (S * kp + 1)
    zero = torch.zeros(n_buf, device="cuda")
    compare(f"scatter_add/route buffer ({n_buf}, {slots.numel()} updates)",
            (sa.scatter_add_(zero.clone(), slots, placed),),
            (sa.scatter_add_plain(zero.clone(), slots, placed),))
    b1, b2, b3 = zero.clone(), zero.clone(), zero.clone()
    touched = int(torch.unique(slots).numel())
    r1 = dict(
        route_ms=timer(lambda: sa.scatter_add_(b1, slots, placed)),
        route_plain_ms=timer(lambda: sa.scatter_add_plain(b2, slots, placed)),
        route_library_ms=timer(lambda: b3.index_add_(0, slots, placed)),
        # every update's index and value read, each touched word read and
        # written
        route_bound_ms=(8 * slots.numel() + 8 * touched) / rate * 1e3,
        route_shape=[n_buf, slots.numel()])
    del b1, b2, b3, zero
    log(f"  scatter_add at the route's shape ({n_buf} words, "
        f"{slots.numel()} updates, {touched} words touched): kernel "
        f"{r1['route_ms']:.4f} ms, plain {r1['route_plain_ms']:.4f} ms, "
        f"index_add_ {r1['route_library_ms']:.4f} ms, bound "
        f"{r1['route_bound_ms']:.5f} ms")
    next(r for r in results if r["name"] == sa.INFO.name).update(r1)

    # row 2: the mesh receive (S lanes on M) and commit (B * S lanes on v)
    ri, rv, ovf = distributed.shard_exchange_batch(spec, idx, vals)
    if int(ovf) != 0:
        raise AssertionError(f"the route overflowed: {int(ovf)}")
    slots_n = ri.shape[-1]
    M = torch.randn(S, width, generator=gen, device="cuda")
    ri0, neg0 = ri[0].contiguous(), (-rv[0]).contiguous()
    live = ri0 >= 0
    M[live.nonzero()[:, 0][::5], ri0[live][::5].long()] = -0.0
    v = torch.randn(W * S, width, generator=gen, device="cuda")
    ids = np.random.default_rng(6).permutation(W)[:B]
    rows = (ids[:, None] * S + np.arange(S)).reshape(-1)
    ri2 = ri.reshape(B * S, slots_n)
    rv2 = rv.reshape(B * S, slots_n)
    compare(f"scatter_add_rows/mesh receive, {S} lanes on ({S}, {width})",
            (sa.scatter_add_rows_(M.clone(), None, ri0, neg0),),
            (sa.scatter_add_rows_plain(M.clone(), None, ri0, neg0),))
    # the whole (W * S, width) result bit for bit, then the lanes' rows
    # through compare (its error pass makes float64 copies: rows only)
    rows_t = torch.from_numpy(rows).cuda()
    a = sa.scatter_add_rows_(v.clone(), rows, ri2, rv2)
    b = sa.scatter_add_rows_plain(v.clone(), rows, ri2, rv2)
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("scatter_add_rows/mesh commit: the (W * S, "
                             "width) results differ")
    compare(f"scatter_add_rows/mesh commit, {B * S} lanes on ({W * S}, "
            f"{width})", (a[rows_t],), (b[rows_t],))
    del a, b

    def lib_operands(rows_t, idx2, vals2):
        """(row, column) pairs and values of the real slots alone."""
        ok = idx2 >= 0
        r = rows_t[:, None].expand_as(idx2)[ok]
        return (r, idx2[ok].long()), vals2[ok]

    ident = torch.arange(S, device="cuda")
    m_lib, m_vals = lib_operands(ident, ri0, neg0)
    v_lib, v_vals = lib_operands(rows_t, ri2, rv2)
    live0, live2 = int((ri0 >= 0).sum()), int((ri2 >= 0).sum())
    r2 = dict(
        mesh_s_ms=timer(lambda: sa.scatter_add_rows_(M, None, ri0, neg0)),
        mesh_s_plain_ms=timer(lambda: sa.scatter_add_rows_plain(
            M, None, ri0, neg0)),
        mesh_s_library_ms=timer(lambda: M.index_put_(m_lib, m_vals,
                                                     accumulate=True)),
        # every slot's index and value read, each live target read and
        # written
        mesh_s_bound_ms=(8 * ri0.numel() + 8 * live0) / rate * 1e3,
        mesh_bs_ms=timer(lambda: sa.scatter_add_rows_(v, rows, ri2, rv2)),
        mesh_bs_plain_ms=timer(lambda: sa.scatter_add_rows_plain(
            v, rows, ri2, rv2)),
        mesh_bs_library_ms=timer(lambda: v.index_put_(v_lib, v_vals,
                                                      accumulate=True)),
        mesh_bs_bound_ms=(8 * ri2.numel() + 8 * live2) / rate * 1e3,
        mesh_shapes=[[S, width, S, slots_n], [W * S, width, B * S, slots_n]])
    log(f"  scatter_add_rows mesh receive ({S} lanes x {slots_n} slots, "
        f"{live0} live): kernel {r2['mesh_s_ms']:.4f} ms, plain "
        f"{r2['mesh_s_plain_ms']:.4f} ms, index_put_ "
        f"{r2['mesh_s_library_ms']:.4f} ms, bound "
        f"{r2['mesh_s_bound_ms']:.5f} ms")
    log(f"  scatter_add_rows mesh commit ({B * S} lanes x {slots_n} slots, "
        f"{live2} live): kernel {r2['mesh_bs_ms']:.4f} ms, plain "
        f"{r2['mesh_bs_plain_ms']:.4f} ms, index_put_ "
        f"{r2['mesh_bs_library_ms']:.4f} ms, bound "
        f"{r2['mesh_bs_bound_ms']:.5f} ms")
    next(r for r in results if r["name"] == sa.ROWS_INFO.name).update(r2)
    del M, v


def scatter_cases(torch, gen, n, idx, vals):
    """The flat scatter-add's cases at the arena size: (name, indices,
    values).  Unique indices; planted duplicates; all k on one index and
    all k inside one CTA's range (several rounds of the kernel's
    ``ROUND`` kept updates in one CTA); duplicates on both sides of a round
    boundary; indices outside [0, n) mixed in; -0 runs with and without
    the sampled engine's +0 pads (the targets of ``idx[:60]`` are set to
    -0 in the arena first); k = 0 and k = 1."""
    from repro_torch.kernels.scatter_apply import ROUND

    k = idx.numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = -(-n // min(n, sms))              # one CTA's range of words

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device="cuda",
                             dtype=torch.int32)

    dup = idx.clone()
    dup[::3] = dup[0]
    dup[1::7] = 123
    straddle = ints(n - w, n, k)          # all in the last CTA's range
    for j in range(1, k // ROUND + 1):
        straddle[j * ROUND - 1:j * ROUND + 1] = n - 7
    oor = idx.clone()
    ar = torch.arange(0, k, 5, device="cuda", dtype=torch.int32)
    oor[::5] = n + ar
    oor[2::5] = -1 - ar[:oor[2::5].numel()]
    oor[3], oor[4], oor[8] = 2**31 - 1, -2**31, n
    zeros = torch.zeros(50, device="cuda")
    neg0 = torch.cat([idx[:50], idx[:50], idx[50:60], idx[60:], idx[:1].repeat(16)])
    neg0_vals = torch.cat([-zeros, zeros, -zeros[:10], vals[60:],
                           torch.zeros(16, device="cuda")])
    return [("unique", idx, vals), ("dups", dup, vals),
            ("all on one index", torch.full_like(idx, 4242), vals),
            ("all in one CTA's range", ints(0, min(w, 3000), k), vals),
            ("duplicates across round boundaries", straddle, vals),
            ("out-of-range indices", oor, vals),
            ("-0 runs and +0 pads", neg0, neg0_vals),
            ("k=0", idx[:0], vals[:0]), ("k=1", idx[:1], vals[:1])]


def plant_blocks(torch, gen, x2d):
    """Adversarial blocks for the block top-k, in place on rows 1-8: all
    zero, all equal, zeros of both signs, denormals, magnitude ties across
    lane and register boundaries, small integers (ties at every rank),
    mostly zero with normals and denormals, and infinities."""
    def normal(size=1024):
        return torch.randn(size, generator=gen, device="cuda")

    sign = torch.where(normal() > 0, 1.0, -1.0)
    mult = torch.randint(0, 5, (1024,), generator=gen,
                         device="cuda").float()
    tiny = torch.tensor(1e-41, device="cuda")     # below 2**-126
    x2d[1] = 0.0
    x2d[2] = 0.5
    x2d[3] = 0.0 * sign
    x2d[4] = mult * tiny * sign
    x2d[4, ::9] = torch.tensor(1e-45, device="cuda") * sign[::9]
    pos = torch.tensor([0, 3, 4, 31, 32, 33, 127, 128, 129, 511, 512, 513,
                        1020, 1023], device="cuda")
    b = normal()
    b[pos] = 3.0 * sign[pos]
    b[pos[:-1] + 1] = 2.5 * sign[pos[:-1]]
    x2d[5] = b
    x2d[6] = torch.round(normal() * 2)
    b = torch.zeros(1024, device="cuda")
    b[::50] = normal(21)
    b[7::33] = mult[7::33] * tiny
    x2d[7] = b
    b = normal()
    b[5], b[700], b[701] = float("inf"), float("-inf"), float("inf")
    x2d[8] = b


def int8_halfway(rng, s: float, count: int) -> np.ndarray:
    """float32 values v whose float32 quotient v / s is exactly n + 0.5
    (|n + 0.5| <= 126.5): where int8's round half to even decides the
    code.  Each starts at (n + 0.5) * s and steps an ulp at a time."""
    s = np.float32(s)
    out = []
    for n in rng.integers(-127, 127, count):
        t = np.float32(n + 0.5)
        v = np.float32(t * s)
        for _ in range(8):
            q = np.float32(v / s)
            if q == t:
                out.append(v)
                break
            v = np.nextafter(v, np.float32(np.inf if q < t else -np.inf))
    return np.asarray(out, np.float32)


def plant_wire(torch, rng, x, seg):
    """The wire kernel's special values, in place, in a (k,) message x cut
    by ``seg``: the segments of two elements get, in order, +0 and -0 (an
    all-zero segment), a NaN and a +inf; a segment of one element a
    denormal; one of 3 to 999 elements a -inf; every longer one +-0,
    +-denormals, bf16 halfway patterns (low 16 bits 0x8000), a planted
    maximum of 100 and int8 halfway values under its scale."""
    from repro_torch.core.sparsify import quantize_scales_plain

    short = iter(("zero", "nan", "inf"))
    off = 0
    for n in seg:
        part = x[off:off + n]
        off += n
        if n == 1:
            part[0] = -3e-39
        elif n == 2:
            kind = next(short, None)
            if kind == "zero":
                part[0], part[1] = 0.0, -0.0
            elif kind is not None:
                part[0] = float(kind)
        elif n < 1000:
            part[n // 2] = float("-inf")
        else:
            part[1::17], part[2::17] = 0.0, -0.0
            part[3::17], part[4::17] = 1e-41, -3e-39
            bits = part[5::13].view(torch.int32)
            part[5::13] = ((bits & -65536) | 0x8000).view(torch.float32)
            part[n // 3] = 100.0
            s = float(quantize_scales_plain(part[None], "int8"))
            vals = int8_halfway(rng, s, min(n // 20, 4096))
            pos = 7 + 17 * np.arange(len(vals))
            keep = pos != n // 3
            part[torch.from_numpy(pos[keep]).cuda()] = \
                torch.from_numpy(vals[keep]).cuda()


def wire_kernels(torch, timer, rate, results, compare, errs):
    """The segmented quantize (rows 5 and 6, ``csrc/wire_pack.cu``)
    against its plain version byte for byte -- codes, shipped values and
    scales as bit patterns -- in bf16, int8 and tern, at a phase B message
    (k = 10,514 in 8 segments), at one 4,718,592-element vector (one
    segment: the two-launch path) and at a (16, k) batch of messages
    (phase C's shape), each with ``plant_wire``'s values; the message also
    at a 4-byte offset, the batch at a row stride of k + 3, the vector
    with a NaN and +-inf in different chunks and with +-inf alone, and a
    (3, k) batch that mixes segments of one chunk with one of three, with
    specials in both.  The simulator's ``quantize_segments`` must ship the
    plain version's bits.  The codec's frame tail (every mode, u8, u16 and
    u32 indices) against its plain version, and ``pack_from_arena``'s
    frames against that tail and against the per-segment
    ``encode_arena_leaf_segments`` (on the card the same kernel: a
    consistency check).  Timed: the wrapper, the C call alone
    and the plain version at each shape and mode, and a message's whole
    ``quantize_pack`` and ``pack_from_arena`` (host time per call, device
    kernels and copies per encode).  No single PyTorch call writes codes
    and shipped values: for bf16 the pair ``x.to(torch.bfloat16).float()``
    is timed beside it, as information."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster import wire
    from repro_torch.core.sparsify import SparseLeaf, quantize_segments
    from repro_torch.kernels import wire_pack

    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    space = full_width_space(torch)
    seg = tuple(space.ks(0.001))              # 10,514 in 8 segments
    k, n_vec = sum(seg), 2304 * 2048
    msg = torch.randn(k, generator=gen, device="cuda")
    plant_wire(torch, rng, msg, seg)
    vec = torch.randn(n_vec, generator=gen, device="cuda")
    plant_wire(torch, rng, vec, (n_vec,))
    batch = torch.randn(16, k, generator=gen, device="cuda")
    for row in batch:
        plant_wire(torch, rng, row, seg)
    odd = torch.empty(k + 1, device="cuda")
    odd[1:] = msg
    wide = torch.zeros(16, k + 3, device="cuda")
    wide[:, :k] = batch
    # the two-launch path with specials: a NaN and +-inf in different
    # chunks of the vector's one segment (the partial pass's NaN flag and
    # the combine of the chunk partials), +-inf alone; and one launch that
    # mixes segments of one chunk (which the partial pass skips) with one
    # of three chunks, a NaN in one chunk and +inf in another
    ch = wire_pack.CHUNK
    vec_nan = torch.randn(n_vec, generator=gen, device="cuda")
    plant_wire(torch, rng, vec_nan, (n_vec,))
    vec_inf = vec_nan.clone()
    vec_nan[5 * ch + 11], vec_nan[-7] = float("nan"), float("-inf")
    vec_nan[100 * ch + 3] = float("inf")
    vec_inf[2 * ch + 1], vec_inf[300 * ch + 5] = float("inf"), float("-inf")
    cut = (3, 2 * ch + 5, 1, 4719)
    mixed = torch.randn(3, sum(cut), generator=gen, device="cuda")
    for row in mixed:
        plant_wire(torch, rng, row, cut)
    mixed[1, 3 + ch + 100], mixed[1, 3 + 2 * ch + 2] = float("nan"), \
        float("inf")
    mixed[2, 3 + 17], mixed[2, 3 + ch + 17] = float("inf"), float("-inf")
    names = {"tern": wire_pack.PACK_INFO.name}
    cases = (("message", msg[None], seg), ("vector", vec[None], (n_vec,)),
             ("batch", batch, seg))
    extra = (("message at a 4-byte offset", odd[1:][None], seg),
             ("batch at row stride k + 3", wide[:, :k], seg),
             ("vector with a NaN and +-inf", vec_nan[None], (n_vec,)),
             ("vector with +-inf", vec_inf[None], (n_vec,)),
             (f"(3, {sum(cut)}) cut {cut}", mixed, cut))
    for (label, x2d, sg), quiet in ([(c, False) for c in cases]
                                    + [(c, True) for c in extra]):
        for mode in ("bf16", "int8", "tern"):
            form = "packed" if mode == "tern" else "element"
            name = names.get(mode, wire_pack.INFO.name)
            got = wire_pack.segment_quantize(x2d, sg, mode, codes=form)
            want = wire_pack.segment_quantize_plain(x2d, sg, mode,
                                                    codes=form)
            compare(f"{name}/{label} {mode}", got, want, quiet=quiet)
            # the simulator's quantizer against the plain version
            sim = quantize_segments(x2d, mode, sg)
            if not torch.equal(sim.view(torch.int32),
                               want.dq.view(torch.int32)):
                raise AssertionError(f"{name}/{label} {mode}: the "
                                     f"simulator's quantize_segments ships "
                                     f"other values than the plain version")
    log(f"  also bit-equal at a 4-byte offset, at row stride k + 3, at the "
        f"vector with a NaN and +-inf in other chunks and with +-inf alone, "
        f"and at a (3, {sum(cut)}) batch cut {cut} with specials; "
        f"quantize_segments ships the plain version's values")
    del vec_nan, vec_inf, mixed
    for label, x2d, sg in cases[::2]:       # tern's codes one per element
        compare(f"{wire_pack.INFO.name}/{label} tern, element codes",
                wire_pack.segment_quantize(x2d, sg, "tern", codes="element"),
                wire_pack.segment_quantize_plain(x2d, sg, "tern",
                                                 codes="element"))

    # the codec: frame tails and whole frames; last, a delta checkpoint's
    # frame: ONE segment of 8 events' changed entries (11 chunks)
    idx = torch.randperm(space.total, generator=gen, device="cuda")[:k]
    idx = idx.sort().values.to(torch.int32)
    small_seg = (4, 9, 20)
    dk = 8 * k + 1
    delta = SparseLeaf(
        torch.randn(dk, generator=gen, device="cuda"),
        torch.randperm(space.total, generator=gen,
                       device="cuda")[:dk].sort().values.to(torch.int32),
        space.total)
    plant_wire(torch, rng, delta.values, (dk,))
    for size in (256, 5000, space.total, "delta"):
        if size == "delta":
            leaf, sg, size = delta, (dk,), space.total
        elif size == space.total:
            leaf = SparseLeaf(msg, idx, size)
            sg = seg
        else:
            ii = torch.randperm(size, generator=gen, device="cuda")[:33]
            leaf = SparseLeaf(msg[1045:1078], ii.sort().values.int(), size)
            sg = small_seg
        for mode in ("none", "bf16", "int8", "tern"):
            name = names.get(mode, wire_pack.INFO.name)
            plain = wire_pack.frame_tail_plain(leaf.values, leaf.indices, sg,
                                               mode, size)
            compare(f"{name}/frame tail {mode}, size {size}",
                    wire_pack.frame_tail(leaf.values, leaf.indices, sg, mode,
                                         size), plain, quiet=True)
            # the frame's tail against the plain version (independent of
            # the kernel); the whole frame against the per-segment encoder
            frame = wire.pack_from_arena(leaf, mode, sg)[0]
            if not frame.endswith(plain[0].cpu().numpy().tobytes()):
                raise AssertionError(f"pack_from_arena {mode}, size {size}: "
                                     f"frame's tail differs from the plain "
                                     f"version's")
            if frame != wire.encode_arena_leaf_segments(leaf, mode, sg)[0]:
                raise AssertionError(f"pack_from_arena {mode}, size {size}: "
                                     f"frame differs from the per-segment "
                                     f"encoder's")
    log("  frame tails bit-equal to the plain version, frames ending in its "
        "bytes and byte-equal to the per-segment encoder: none, bf16, int8, "
        f"tern at u8, u16 and u32 indices, and at one segment of {dk} "
        f"(a delta checkpoint's frame)")

    def launch_alone(x2d, sg, mode, form):
        """The C call alone (``wire_pack.launcher``), on outputs that one
        wrapper call made beforehand."""
        q = wire_pack.segment_quantize(x2d, sg, mode, codes=form)
        return wire_pack.launcher(
            x2d, sg, mode, scales=q.scales, dq=q.dq, codes=q.codes,
            code_stride=q.codes.stride(0) * q.codes.element_size(),
            form=form)[0]

    # timed on the main path's kind of values, with no specials: a
    # denormal sends the IEEE division of int8's codes down its slow path
    def normal(*shape):
        x = torch.randn(*shape, generator=gen, device="cuda")
        x[..., ::9] = 0.0
        x[..., 4::17] = -0.0
        return x

    msg, vec, batch = normal(k), normal(n_vec), normal(16, k)
    cases = (("message", msg[None], seg), ("vector", vec[None], (n_vec,)),
             ("batch", batch, seg))
    rows = {}
    for label, x2d, sg in cases:
        B, kk = x2d.shape
        for mode in ("bf16", "int8", "tern"):
            form = "packed" if mode == "tern" else "element"
            code_bytes = {"bf16": 2 * kk, "int8": kk,
                          "tern": (kk + 3) // 4}[mode]
            # x read once; dq, the codes and the scales written once
            nbytes = B * (8 * kk + code_bytes + 4 * len(sg))
            t = dict(
                ms=timer(lambda: wire_pack.segment_quantize(
                    x2d, sg, mode, codes=form)),
                launch_ms=timer(launch_alone(x2d, sg, mode, form)),
                plain_ms=timer(lambda: wire_pack.segment_quantize_plain(
                    x2d, sg, mode, codes=form), reps=5),
                bound_ms=nbytes / rate * 1e3,
                host_us=host_us(torch, lambda: wire_pack.segment_quantize(
                    x2d, sg, mode, codes=form)))
            pair = ""
            if mode == "bf16":
                t["pair_ms"] = timer(lambda: x2d.to(torch.bfloat16).float())
                pair = f", x.to(bfloat16).float() {t['pair_ms']:.4f} ms"
            rows[label, mode] = t
            log(f"  segment_quantize {label} ({B} x {kk}, {len(sg)} "
                f"segments) {mode}: wrapper {t['ms']:.4f} ms (launch alone "
                f"{t['launch_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms"
                f"{pair}, bound {t['bound_ms']:.5f} ms; host per call "
                f"{t['host_us']:.1f} us")

    # a message's whole codec calls
    leaf = SparseLeaf(msg, idx, space.total)
    codec = {}
    for mode in ("none", "bf16", "int8", "tern"):
        c = {}
        if mode != "none":
            c["quantize_pack_ms"] = timer(lambda: wire_pack.quantize_pack(
                msg, mode=mode, seg=seg))
            c["quantize_pack_host_us"] = host_us(
                torch, lambda: wire_pack.quantize_pack(msg, mode=mode,
                                                       seg=seg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            wire.pack_from_arena(leaf, mode, seg)
        c["pack_from_arena_us"] = (time.perf_counter() - t0) / 100 * 1e6
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                wire.pack_from_arena(leaf, mode, seg)
            torch.cuda.synchronize()
        dev = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA
               and a.self_device_time_total > 0]
        c["kernels_per_encode"] = sum(
            a.count for a in dev if "Memcpy" not in a.key) / 10
        c["copies_per_encode"] = sum(
            a.count for a in dev if "Memcpy" in a.key) / 10
        codec[mode] = c
        qp = ("" if mode == "none" else
              f"quantize_pack {c['quantize_pack_ms']:.4f} ms (host "
              f"{c['quantize_pack_host_us']:.1f} us a call), ")
        log(f"  codec {mode}, one message: {qp}pack_from_arena "
            f"{c['pack_from_arena_us']:.1f} us a call (host, its wait "
            f"included), {c['kernels_per_encode']:.1f} device kernels and "
            f"{c['copies_per_encode']:.1f} copies per encode")

    # the table rows: a phase B message, int8 (phase B's and D1's UP) and
    # tern with packed codes (D2's UP)
    for info, mode in ((wire_pack.INFO, "int8"),
                       (wire_pack.PACK_INFO, "tern")):
        t = rows["message", mode]
        results.append(dict(
            name=info.name, route="cuda", source=info.source,
            replaces=info.replaces, max_abs_err=errs[info.name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by="bytes",
            library_ms=None, launch_ms=t["launch_ms"],
            shapes={f"{label} {m}": v for (label, m), v in rows.items()},
            codec=codec))


# ---------------------------------------------------------------------------
# phase A: the quickstart configuration, card against CPU
# ---------------------------------------------------------------------------

def _blobs(rng, centers, n, noise):
    y = rng.integers(0, centers.shape[0], n)
    x = centers[y] + noise * rng.normal(size=(n, centers.shape[1]))
    return x.astype(np.float32), y.astype(np.int64)


def phase_a(torch):
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import async_sim, make_strategy
    from repro_torch.models.mlp import MLP

    rng = np.random.default_rng(0)
    params_np = {"w1": (rng.normal(size=(64, 64)) * 0.18).astype(np.float32),
                 "b1": np.zeros(64, np.float32),
                 "w2": (rng.normal(size=(64, 10)) * 0.18).astype(np.float32),
                 "b2": np.zeros(10, np.float32)}
    centers = rng.normal(size=(10, 64))
    pool = [_blobs(rng, centers, 32, 0.8) for _ in range(600)]
    evx, evy = _blobs(rng, centers, 1024, 0.8)
    sched = async_sim.make_schedule(8, 600, seed=1, hetero=0.8)
    out = {}
    for dev in ("cuda", "cpu"):
        model = MLP((64, 64, 10), start=1, device=dev)
        batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
                   for x, y in pool]
        ev = (torch.from_numpy(evx).to(dev), torch.from_numpy(evy).to(dev))
        for name, kw in (("asgd", {}),
                         ("dgs", {"density": 0.01, "momentum": 0.7})):
            tr = async_sim.AsyncTrainer(make_strategy(name, **kw),
                                        model.grad_fn, 8, lr=0.1, device=dev)
            t0 = time.perf_counter()
            final, _, hist = tr.run(params_from_numpy(params_np, dev), sched,
                                    lambda e, k: batches[e])
            if dev == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            acc = model.accuracy(final, ev)
            out[dev, name] = (hist, acc)
            log(f"  {dev:4s} {name:4s} acc={acc:.4f} up={hist.up_bytes} "
                f"down={hist.down_bytes} loss[-1]={hist.losses[-1]:.6f} "
                f"{600 / dt:.1f} events/s")
    for name in ("asgd", "dgs"):
        (hg, ag), (hc, ac) = out["cuda", name], out["cpu", name]
        if name == "dgs":
            # sparse frames are static: bytes must be identical
            if (hg.up_bytes, hg.down_bytes) != (hc.up_bytes, hc.down_bytes):
                raise AssertionError(f"dgs bytes differ: "
                                     f"{hg.up_bytes, hg.down_bytes} vs "
                                     f"{hc.up_bytes, hc.down_bytes}")
        else:
            # dense frames count nonzeros, which the two devices' roundings
            # may move by a few exact zeros
            for a, b in ((hg.up_bytes, hc.up_bytes),
                         (hg.down_bytes, hc.down_bytes)):
                if abs(a - b) > 1e-3 * b:
                    raise AssertionError(f"asgd bytes differ >0.1%: {a} {b}")
        # matmul reductions run in another order on the card, so losses
        # drift by float32 rounding; 40 events keep that inside 1e-4
        np.testing.assert_allclose(hg.losses[:40], hc.losses[:40], rtol=1e-4)
        # over 600 events rounding flips a few top-k choices and the runs
        # diverge slightly; the models must still classify alike
        if abs(ag - ac) > 0.03:
            raise AssertionError(f"{name}: accuracy {ag} vs {ac}")
        log(f"  {name}: card and CPU agree (bytes, losses[:40] rtol 1e-4, "
            f"accuracy {ag:.4f} vs {ac:.4f})")


# ---------------------------------------------------------------------------
# phase B: full width on the card, through the kernels
# ---------------------------------------------------------------------------

FULL_CAP = 96       # events of the full-width runs (run_big's own cap)
FULL_DIMS = (512, 2048, 2304, 2048, 10)   # run_big's MLP
# the kernel rows whose launch counts come from phase B; the multi-row
# scatter-add's takes phase C's, the batched loop it was written for, and
# the tern packing's phase D2's, the codec that packs
SERIAL_ROWS = ("scatter_add", "block_topk", "samomentum_fused",
               "samomentum_accumulate", "fma", "segment_quantize",
               "row_topk")
# the kernels the simulator's loops run (phases B and C); the tern packing
# runs in the codec only, phase D
SIM_KERNELS = SERIAL_ROWS + ("scatter_add_rows",)


def check_quantize_launches(label, launches, steps, n_leaves):
    """Phases B and C quantize one int8 UP message per step (an event, a
    batch) in ONE launch of the segmented quantize (the DOWN message is
    "none": none), pack no tern codes, and launch the fused multiply-add
    only in the repair's epilogue, once per leaf and step (the int8 scale
    is the quantize kernel's own)."""
    want = {"segment_quantize": steps, "segment_quantize_tern_pack": 0,
            "fma": n_leaves * steps}
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    log(f"  {label}: launches as expected: {want}")


def _full_width_params(torch, rng):
    """run_big's MLP's weights on the card, drawn from ``rng`` (He's scale,
    zero biases), and the ParamSpace of their arena: 10,512,650 elements
    in 8 leaves, in the arena's (sorted-key) order."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.paramspace import ParamSpace

    params_np = {}
    for i, (a, b) in enumerate(zip(FULL_DIMS[:-1], FULL_DIMS[1:])):
        params_np[f"w{i}"] = (rng.normal(size=(a, b)).astype(np.float32)
                              * np.float32((2.0 / a) ** 0.5))
        params_np[f"b{i}"] = np.zeros(b, np.float32)
    params0 = params_from_numpy(params_np, "cuda")
    return params0, ParamSpace.from_tree(params0)


def full_width_space(torch):
    """The ParamSpace of phases B-D: leaf offsets and sizes of the arena."""
    return _full_width_params(torch, np.random.default_rng(0))[1]


def _full_width(torch):
    """Phase B's and phase C's shared set-up: the 10.5M-parameter MLP from
    a seed, the first 96 events of run_big's schedule and their batches,
    and the trainer.  Returns (space, params0, sched, batch_fn, trainer)."""
    from repro_torch.core import async_sim, make_strategy
    from repro_torch.core.engine import CompressionSpec
    from repro_torch.models.mlp import MLP

    dims = FULL_DIMS
    n_workers, n_events = 100, 1_000_000
    rng = np.random.default_rng(0)
    params0, space = _full_width_params(torch, rng)
    sched = async_sim.make_schedule(n_workers, n_events, seed=7,
                                    hetero=0.8)[:FULL_CAP]
    centers = rng.normal(size=(10, 512))
    pool = []
    for _ in range(FULL_CAP):
        x, y = _blobs(rng, centers, 8, 1.0)
        pool.append((torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()))
    model = MLP(dims, device="cuda")
    strat = make_strategy("dgs", density=0.001, momentum=0.7,
                          quantize="int8", engine="blockwise")
    sspec = CompressionSpec(engine="blockwise", block_r=32)
    tr = async_sim.AsyncTrainer(strat, model.grad_fn, n_workers, lr=0.05,
                                secondary_density=0.001, secondary_spec=sspec)
    return space, params0, sched, (lambda e, k: pool[e]), tr


def phase_b(torch, results, ref):
    """The serial loop at full width.  Leaves its results, on the host, in
    ``ref`` for phase C to be held against."""
    from repro_torch import kernels
    from repro_torch.cluster import wire
    from repro_torch.core import async_sim

    space, params0, sched, batch_fn, tr = _full_width(torch)
    cap, sspec = FULL_CAP, tr.secondary_spec
    log(f"  model: {space.total} parameters in {space.n_leaves} tensors")
    pool = [batch_fn(e, 0) for e in range(cap)]

    tr.run(params0, sched[:8], batch_fn)          # warm-up (lazy set-up)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    final, sstate, hist = tr.run(params0, sched, batch_fn)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {info.name: info.launches for info in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    log(f"  {cap} events in {dt:.3f} s: {cap / dt:.2f} events/s "
        f"(worker and server state set-up included)")
    log(f"  launches: {launches} ({ {k: v / cap for k, v in launches.items()} }"
        f" per event)")
    log(f"  peak device memory {peak / 2**30:.2f} GiB")
    for row in results:
        if row["name"] in SERIAL_ROWS:
            row["launches"] = launches[row["name"]]
    if min(launches[name] for name in SIM_KERNELS) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    check_quantize_launches("B", launches, cap, space.n_leaves)
    if not np.all(np.isfinite(hist.losses)):
        raise AssertionError("non-finite loss")
    up = cap * wire.frame_bytes_static(space.ks(0.001), space.total, "int8")
    down = cap * wire.frame_bytes_static(space.ks(0.001), space.total, "none")
    if (hist.up_bytes, hist.down_bytes) != (up, down):
        raise AssertionError(f"bytes {hist.up_bytes, hist.down_bytes} != "
                             f"{up, down}")
    for key, t in final.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite parameter {key}")
    log(f"  losses first/last {hist.losses[0]:.5f} / {hist.losses[-1]:.5f}; "
        f"up {hist.up_bytes} B, down {hist.down_bytes} B (static frames)")
    ref.update(final={key: t.cpu() for key, t in final.items()},
               M=sstate.M.cpu(), v=sstate.v.cpu(), hist=hist,
               launches=launches, events_s=cap / dt)
    del final, sstate

    # per-stage split: the same stage functions as run(), replayed with
    # CUDA events between them (an instrumented copy of run's loop)
    stages = ("client", "quantize_up", "server", "quantize_down", "commit",
              "apply")
    spent = {s: 0.0 for s in stages}
    sstate, workers = tr.init(params0)
    client = async_sim.make_client_step(tr.strategy, tr.grad_fn, space)
    server = async_sim.make_server_step(tr.secondary_density, sspec)
    commit, apply_g = async_sim.make_commit(), async_sim.make_apply()
    up_seg = space.ks(0.001)

    def replay(e):
        """One event through the stages; returns CUDA events between them."""
        nonlocal sstate
        k = int(sched[e])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        wst, loss, msg = client(workers[k]["theta"], workers[k]["strat"],
                                pool[e], tr.lr)
        ev[1].record()
        msg = wire.quantize_message(msg, "int8", seg=up_seg)
        ev[2].record()
        sstate, G = server(sstate, msg, k)
        ev[3].record()
        G = wire.quantize_message(G, "none", seg=up_seg)
        ev[4].record()
        sstate = commit(sstate, k, G)
        ev[5].record()
        workers[k]["theta"] = apply_g(workers[k]["theta"], G)
        workers[k]["strat"] = wst
        ev[6].record()
        return ev

    n_replay = min(32, cap)
    for e in range(n_replay):
        ev = replay(e)
        ev[6].synchronize()
        for i, s in enumerate(stages):
            spent[s] += ev[i].elapsed_time(ev[i + 1])
    total = sum(spent.values())
    log(f"  per-event stage split over {n_replay} replayed events "
        f"(ms/event, CUDA events; a stage the host enqueues slower than the "
        f"card runs it shows its enqueue time): " + ", ".join(
            f"{s} {spent[s] / n_replay:.3f}" for s in stages)
        + f"; sum {total / n_replay:.3f}")

    # device busy share and kernel time by name over a short window
    from torch.profiler import ProfilerActivity, profile
    window = range(n_replay, min(n_replay + 8, cap))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for e in window:
            replay(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies, fills): an aten op's row also
    # carries the time of the kernels it launched, and would count it twice
    device = [a for a in prof.key_averages()
              if a.device_type == torch.autograd.DeviceType.CUDA
              and a.self_device_time_total > 0]
    rows = [(a.self_device_time_total, a.key) for a in device]
    busy_us = sum(t for t, _ in rows)
    if busy_us == 0:
        log("  profiler: no device time recorded (busy share not measured)")
    else:
        ref["busy_ms"] = busy_us / 1e3 / len(window)
        log(f"  profiler over {len(window)} events: device busy "
            f"{busy_us / 1e3 / len(window):.3f} ms/event of "
            f"{wall * 1e3 / len(window):.3f} ms/event wall "
            f"({busy_us / 1e6 / wall:.3f} busy share), "
            f"{sum(a.count for a in device) / len(window):.1f} device "
            f"kernels and copies per event")
        for t, key in sorted(rows, reverse=True)[:10]:
            log(f"    {t / 1e3 / len(window):8.3f} ms/event  {key[:90]}")
        for label, part in (("block top-k", "block_topk_"),
                            ("row top-k", "row_topk_"),
                            ("scatter-add (flat and rows)",
                             "scatter_add_kernel"),
                            ("SAMomentum passes and fma", "rowmap_kernel"),
                            ("segmented quantize", "segment_quantize_kernel"),
                            ("float64 (names containing 'double')",
                             "double")):
            t = sum(t for t, key in rows if part in key)
            log(f"  profiler: {label} kernels {t / 1e3 / len(window):.3f} "
                f"ms/event")
        doubles = [key for _, key in rows if "double" in key]
        if doubles:
            raise AssertionError(f"float64 kernels in the loop: {doubles}")
    del sstate, workers


# ---------------------------------------------------------------------------
# phase E: phase B's run as one CUDA graph of the event, replayed per event
# ---------------------------------------------------------------------------

def _graph_window(torch, prof, n_replays):
    """Device time of the replays in a profiler trace of a scan: the device
    rows that start after the first graph launch.  Returns (busy ms/event,
    busy share of the window from that launch to the last row's end,
    device rows per event, [(ms/event, name)] of the ten costliest names),
    or None when the trace shows no graph launch or no device row after
    it."""
    events = prof.events()
    launches = [ev.time_range.start for ev in events
                if "GraphLaunch" in ev.name]
    if not launches:
        return None
    start = min(launches)
    rows = [ev for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.time_range.start >= start and ev.time_range.elapsed_us()]
    if not rows:
        return None
    end = max(ev.time_range.end for ev in rows)
    busy = sum(ev.time_range.elapsed_us() for ev in rows)
    by_name: dict = {}
    for ev in rows:
        by_name[ev.name] = by_name.get(ev.name, 0) + ev.time_range.elapsed_us()
    top = sorted(((t / 1e3 / n_replays, name) for name, t in by_name.items()),
                 reverse=True)[:10]
    return busy / 1e3 / n_replays, busy / (end - start), \
        len(rows) / n_replays, top


def phase_e(torch, results, ref):
    """``run_async_scan`` on phase B's configuration, schedule and batches
    (stacked on the card): event 0 eagerly, then one CUDA graph of the
    event, replayed for the other 95.  Bit-equal to phase B (losses, final
    params, M, v, bytes), every kernel's launches equal to phase B's (the
    replays counted by the capture's record), the segmented quantize once
    per event; a run with ``metrics=True`` (the fold inside the graph)
    bit-equal too, its drained counts those of the schedule.  Prints
    events/s beside phase B's, capture seconds, host us per replay, peak
    memory, and device ms/event and busy share from a profiler window over
    a further run's replays."""
    from repro_torch import kernels
    from repro_torch.core import scan_runner
    from repro_torch.telemetry import Recorder

    if "hist" not in ref:
        raise AssertionError("phase B left no result to hold phase E to")
    space, params0, sched, batch_fn, tr = _full_width(torch)
    cap = FULL_CAP
    pool = [batch_fn(e, 0) for e in range(cap)]
    batches = (torch.stack([x for x, _ in pool]),
               torch.stack([y for _, y in pool]))
    del pool

    def scan(schedule, data, recorder=None, metrics=False):
        return scan_runner.run_async_scan_with_state(
            tr.strategy, tr.grad_fn, params0, schedule, data,
            n_workers=tr.n_workers, lr=tr.lr,
            secondary_density=tr.secondary_density,
            secondary_spec=tr.secondary_spec, recorder=recorder,
            metrics=metrics, device="cuda")

    def same_as_b(label, final, sstate, hist):
        want = ref["hist"]
        if not np.array_equal(hist.losses, want.losses):
            raise AssertionError(f"{label}: losses differ from phase B")
        if (hist.up_bytes, hist.down_bytes) != (want.up_bytes,
                                                want.down_bytes):
            raise AssertionError(f"{label}: bytes differ from phase B")
        for key, t in final.items():
            if not torch.equal(t.cpu(), ref["final"][key]):
                raise AssertionError(f"{label}: final {key} differs from "
                                     f"phase B")
        for name, t in (("M", sstate.M), ("v", sstate.v)):
            if not torch.equal(t.cpu(), ref[name]):
                raise AssertionError(f"{label}: {name} differs from phase B")

    scan(sched[:8], tuple(b[:8] for b in batches))     # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace_dir = ROOT / "build" / "phase_e_trace"
    rec = Recorder(trace_dir)
    kernels.reset_launches()
    t0 = time.perf_counter()
    final, sstate, hist = scan(sched, batches, rec)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec.instant("phase_e/synced")
    launches = {info.name: info.launches for info in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    rec.close()
    marks = {ev["name"]: ev for ev in json.loads(
        (trace_dir / "trace.json").read_text())["traceEvents"]}
    capture_s = marks["scan/capture"]["dur"] / 1e6
    execute_s = marks["scan/execute"]["dur"] / 1e6
    # from the first replay's enqueue to the sync after the last
    replay_s = (marks["phase_e/synced"]["ts"]
                - marks["scan/execute"]["ts"]) / 1e6
    log(f"  {cap} events in {dt:.3f} s: {cap / dt:.2f} events/s, one sync "
        f"at the end (state set-up, event 0 and the capture included); "
        f"phase B {ref['events_s']:.2f} events/s in this run")
    log(f"  event 0 eagerly and the capture: {capture_s:.3f} s; "
        f"{cap - 1} replays enqueued in {execute_s * 1e3:.3f} ms: "
        f"{execute_s / (cap - 1) * 1e6:.1f} host us per replay; "
        f"{replay_s * 1e3 / (cap - 1):.3f} wall ms per replayed event, "
        f"{(cap - 1) / replay_s:.2f} events/s over the replays")
    log(f"  launches: {launches} ({ {k: v / cap for k, v in launches.items()} }"
        f" per event)")
    log(f"  peak device memory {peak / 2**30:.2f} GiB")
    for row in results:
        row["launches_e"] = launches[row["name"]]
    if launches != ref["launches"]:
        raise AssertionError(f"launches {launches} differ from phase B's "
                             f"{ref['launches']}")
    check_quantize_launches("E", launches, cap, space.n_leaves)
    same_as_b("E", final, sstate, hist)
    log("  bit-equal to phase B: losses, final params, M, v, bytes; "
        "every kernel's launches equal phase B's")
    del final, sstate

    # the metrics fold inside the graph: no bit changes, every event counted
    final, sstate, hist = scan(sched, batches, metrics=True)
    same_as_b("E with metrics", final, sstate, hist)
    md = hist.metrics
    from repro_torch.telemetry import metrics as metrics_lib
    if md["n_events"] != cap or sum(md["update_mag_hist"]["counts"]) != cap \
            or md["per_worker"] != np.bincount(
                sched, minlength=tr.n_workers).tolist() \
            or md["staleness_hist"] != metrics_lib.summarize_log2(
                hist.staleness):
        raise AssertionError(f"E with metrics: {md}")
    log(f"  with metrics=True: bit-equal to phase B; drained {md['n_events']}"
        f" events, staleness {md['staleness_hist']}")
    del final, sstate

    # device time per event over a further run's replays
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan(sched, batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    window = _graph_window(torch, prof, cap - 1)
    if window is not None:
        busy_ms, share, per_event, top = window
        log(f"  profiler over the {cap - 1} replays of a further run: device "
            f"busy {busy_ms:.3f} ms/event, {share:.3f} busy share of the "
            f"replay window (phase B: {ref.get('busy_ms', float('nan')):.3f}"
            f" ms/event), {per_event:.1f} device kernels and copies per "
            f"event; the run {cap / wall:.2f} events/s under the profiler")
        for ms, name in top:
            log(f"    {ms:8.3f} ms/event  {name[:90]}")
    else:
        wall_ms = replay_s * 1e3 / (cap - 1)
        log(f"  profiler: no graph kernels in the trace; phase B's device "
            f"{ref.get('busy_ms', float('nan')):.3f} ms/event over E's "
            f"{wall_ms:.3f} wall ms per replayed event: busy share "
            f"{ref.get('busy_ms', float('nan')) / wall_ms:.3f} (derived)")


# ---------------------------------------------------------------------------
# phase C: phase B's run through the batched loop
# ---------------------------------------------------------------------------

def phase_c(torch, results, ref):
    """run_batched(max_batch=16) on phase B's configuration, schedule and
    batches, with a Recorder and the metrics on; bit-equal to phase B."""
    from repro_torch import kernels
    from repro_torch.core import async_sim
    from repro_torch.telemetry import Recorder

    if "hist" not in ref:
        raise AssertionError("phase B left no result to hold phase C to")
    space, params0, sched, batch_fn, tr = _full_width(torch)
    cap = FULL_CAP
    batches = async_sim.batch_schedule(sched, max_batch=16)
    log(f"  {len(batches)} batches of {[len(b) for b in batches]} events "
        f"(mean {cap / len(batches):.2f})")
    tr.run_batched(params0, sched[:16], batch_fn, max_batch=16)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace_dir = ROOT / "build" / "phase_c_trace"
    rec = Recorder(trace_dir)
    kernels.reset_launches()
    t0 = time.perf_counter()
    final, sstate, hist = tr.run_batched(params0, sched, batch_fn,
                                         max_batch=16, recorder=rec,
                                         metrics=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {info.name: info.launches for info in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    rec.close()
    log(f"  {cap} events in {dt:.3f} s: {cap / dt:.2f} events/s "
        f"(stacked worker and server state set-up included)")
    log(f"  launches: {launches} ({ {k: v / cap for k, v in launches.items()} }"
        f" per event)")
    log(f"  peak device memory {peak / 2**30:.2f} GiB")
    spans: dict = {}
    trace = json.loads((trace_dir / "trace.json").read_text())
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    log("  host span totals (ms, enqueue time: no sync inside the loop): "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
        + f"; sum {sum(spans.values()):.3f} of {dt * 1e3:.3f} wall")
    for row in results:
        if row["name"] == "scatter_add_rows":
            row["launches"] = launches[row["name"]]
    if min(launches[name] for name in SIM_KERNELS) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    check_quantize_launches("C", launches, len(batches), space.n_leaves)
    rows_launches = launches["scatter_add_rows"]
    if rows_launches != len(batches) * (2 + space.n_leaves):
        raise AssertionError(f"kernel 4 launched {rows_launches} times, not "
                             f"once per commit, apply and leaf repair of "
                             f"{len(batches)} batches")
    want = ref["hist"]
    if not np.array_equal(hist.losses, want.losses):
        raise AssertionError("losses differ from phase B")
    if (hist.up_bytes, hist.down_bytes) != (want.up_bytes, want.down_bytes):
        raise AssertionError("bytes differ from phase B")
    for key, t in final.items():
        if not torch.equal(t.cpu(), ref["final"][key]):
            raise AssertionError(f"final {key} differs from phase B")
    for name, t in (("M", sstate.M), ("v", sstate.v)):
        if not torch.equal(t.cpu(), ref[name]):
            raise AssertionError(f"{name} differs from phase B")
    md = hist.metrics
    if md["n_events"] != cap or sum(md["update_mag_hist"]["counts"]) != cap:
        raise AssertionError(f"metrics: {md}")
    log("  bit-equal to phase B: losses, final params, M, v, bytes; metrics "
        f"drained: {md['n_events']} events, staleness "
        f"{md['staleness_hist']}")
    del final, sstate


# ---------------------------------------------------------------------------
# phase D: the cluster runtime at full width
# ---------------------------------------------------------------------------

CLUSTER_SPANS = ("coord/server_batch", "coord/encode", "coord/commit",
                 "coord/reply", "client/step", "client/encode",
                 "client/exchange", "client/apply",
                 # the serve leg's (phase F)
                 "coord/push", "coord/sync", "coord/ckpt", "replica/apply",
                 "replica/decode", "replica/sync")


def _trace_spans(trace_dir):
    """Host span totals (ms) of a Recorder's trace, and its serving window
    (s): from the first ``coord/server_batch`` start to the last
    ``coord/reply`` end."""
    spans: dict = {}
    first, last = float("inf"), 0.0
    trace = json.loads((trace_dir / "trace.json").read_text())
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "X" or ev["name"] not in CLUSTER_SPANS:
            continue
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
        if ev["name"] == "coord/server_batch":
            first = min(first, ev["ts"])
        if ev["name"] == "coord/reply":
            last = max(last, ev["ts"] + ev["dur"])
    return spans, (last - first) / 1e6


def _log_spans(label, spans, window, n_events):
    log(f"  {label}: host span totals (ms; the clients' spans overlap): "
        + ", ".join(f"{k} {spans[k]:.3f}" for k in CLUSTER_SPANS
                    if k in spans))
    log(f"  {label}: serving window {window * 1e3:.3f} ms, "
        f"{(n_events - 1) / window:.2f} events/s within it")
    log(f"  {label}: codec spans per event: " + ", ".join(
        f"{k} {spans[k] / n_events:.4f} ms"
        for k in ("client/encode", "coord/encode") if k in spans))


def _cluster_run(torch, label, tr, params0, sched, batch_fn, trace_dir,
                 **serve):
    """One ``run_inprocess`` of trainer ``tr``'s configuration, one worker
    slot per trainer worker, with a Recorder (and ``serve``: the serve leg's
    options); the launch counters are set to 0 just before it and read just
    after.  Prints events/s, peak memory, launches per event, the mean
    batch and the host span totals.  Returns (final, hist, launches,
    events/s)."""
    from repro_torch import kernels
    from repro_torch.cluster import run_inprocess
    from repro_torch.telemetry import Recorder

    cap = len(sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = Recorder(trace_dir)
    kernels.reset_launches()
    t0 = time.perf_counter()
    final, hist = run_inprocess(
        tr.strategy, tr.grad_fn, params0, batch_fn, schedule=sched,
        n_workers=tr.n_workers, lr=tr.lr,
        secondary_density=tr.secondary_density,
        secondary_spec=tr.secondary_spec, recorder=rec, timeout=300.0,
        **serve)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {info.name: info.launches for info in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    rec.close()
    batches = hist.metrics["batch_sizes"]
    log(f"  {label}: {cap} events in {dt:.3f} s: {cap / dt:.2f} events/s "
        f"(client threads' set-up included), {len(batches)} server passes, "
        f"mean batch {cap / len(batches):.2f}")
    log(f"  {label}: launches {launches} "
        f"({ {k: v / cap for k, v in launches.items()} } per event)")
    log(f"  {label}: peak device memory {peak / 2**30:.2f} GiB")
    _log_spans(label, *_trace_spans(trace_dir), cap)
    log(f"  {label}: wall {dt * 1e3:.3f} ms")
    return final, hist, launches, cap / dt


def _same_run(torch, label, final, hist, want_final, want,
              check_bytes=True):
    """Bit-equality of two runs: losses, worker ids, staleness, final
    params, and (``check_bytes``) up and down bytes."""
    for field in ("losses", "worker_ids", "staleness"):
        if not np.array_equal(getattr(hist, field), getattr(want, field)):
            raise AssertionError(f"{label}: {field} differ")
    if check_bytes and (hist.up_bytes, hist.down_bytes) != (
            want.up_bytes, want.down_bytes):
        raise AssertionError(f"{label}: bytes {hist.up_bytes, hist.down_bytes}"
                             f" != {want.up_bytes, want.down_bytes}")
    for key, t in final.items():
        if not torch.equal(t.cpu(), want_final[key].cpu()):
            raise AssertionError(f"{label}: final {key} differs")


def _child_env() -> dict:
    """The environment of a launcher subprocess: this one, with the
    checkout's ``src`` first on ``PYTHONPATH``."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return env


def _run_launcher(label, module, flags, env):
    """``python -m <module> <flags>`` from the checkout's root; prints the
    output's last lines and fails unless it exits 0.  Returns the output."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *flags], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=400)
    out = proc.stdout + proc.stderr
    for line in out.strip().splitlines()[-10:]:
        log(f"  {label} | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{label}: {module} exited {proc.returncode}")
    log(f"  {label}: exit 0 in {time.perf_counter() - t0:.1f} s (process "
        f"start-up included)")
    return out


def phase_d(torch, results, ref):
    """The cluster runtime at full width: D1 against phase B, D2 against
    the serial loop of its own configuration, D3 the TCP launcher."""
    import dataclasses

    from repro_torch.core import make_strategy

    if "hist" not in ref:
        raise AssertionError("phase B left no result to hold phase D1 to")
    space, params0, sched, batch_fn, tr = _full_width(torch)
    cap = FULL_CAP
    log(f"  schedule: {cap} events, {len(set(sched.tolist()))} distinct "
        f"workers, {tr.n_workers} slots")

    # D1: phase B's configuration (int8 up, none down), bit-equal to B
    final, hist, launches, eps = _cluster_run(
        torch, "D1", tr, params0, sched, batch_fn,
        ROOT / "build" / "phase_d1_trace")
    _same_run(torch, "D1", final, hist, ref["final"], ref["hist"])
    ref["d1_launches"], ref["d1_events_s"] = launches, eps   # for phase F1
    # every encode is one launch: an int8 UP and a "none" DOWN per event
    got = (launches["segment_quantize"],
           launches["segment_quantize_tern_pack"])
    if got != (2 * cap, 0):
        raise AssertionError(f"D1: the segmented quantize launched {got}, "
                             f"expected an int8 UP and a none DOWN per "
                             f"event: {(2 * cap, 0)}")
    log("  D1 bit-equal to phase B: losses, worker ids, staleness, final "
        "params, up and down bytes")
    del final

    # D2: tern up, bf16 down; held to the serial loop of the same
    # configuration, run here on the card
    tr2 = dataclasses.replace(
        tr, strategy=make_strategy("dgs", density=0.001, momentum=0.7,
                                   quantize="tern", engine="blockwise"),
        secondary_spec=dataclasses.replace(tr.secondary_spec,
                                           quantize="bf16"))
    t0 = time.perf_counter()
    want_final, sstate, want = tr2.run(params0, sched, batch_fn)
    del sstate                 # D2's peak memory is the cluster's alone
    torch.cuda.synchronize()
    log(f"  D2 serial reference run: {cap / (time.perf_counter() - t0):.2f} "
        f"events/s")
    want_final = {key: t.cpu() for key, t in want_final.items()}
    final, hist, launches, _ = _cluster_run(
        torch, "D2", tr2, params0, sched, batch_fn,
        ROOT / "build" / "phase_d2_trace")
    _same_run(torch, "D2", final, hist, want_final, want)
    # a tern UP (packed codes) and a bf16 DOWN per event, one launch each
    got = (launches["segment_quantize"],
           launches["segment_quantize_tern_pack"])
    if got != (cap, cap):
        raise AssertionError(f"D2: the segmented quantize launched {got}, "
                             f"expected a bf16 DOWN and a tern UP per event:"
                             f" {(cap, cap)}")
    log("  D2 bit-equal to the serial run: losses, worker ids, staleness, "
        "final params, up and down bytes")
    row = next(r for r in results
               if r["name"] == "segment_quantize_tern_pack")
    row["launches"] = launches["segment_quantize_tern_pack"]
    del final, want_final

    # D3: the TCP launcher's smoke, two client processes on the card
    env = _child_env()
    _run_launcher("D3", "repro_torch.launch.cluster",
                  ["--smoke", "--timeout", "120"], env)
    phase_d4(torch, env)


# D4: the TCP launcher at phase B's widths and density
D4_FLAGS = ["--clients", "4", "--rounds", "8", "--features", "512",
            "--hidden", "2048,2304,2048", "--classes", "10",
            "--batch-size", "8", "--strategy", "dgs", "--density", "0.001",
            "--momentum", "0.7", "--quantize", "int8",
            "--secondary-density", "0.001", "--lr", "0.05",
            "--timeout", "120"]


def phase_d4(torch, env):
    """``python -m repro_torch.launch.cluster`` at full width: a coordinator
    and 4 client processes over TCP on the card.  Its events and measured
    up and down bytes must equal an in-process run of the same problem
    (the launcher's own ``problem``) over a schedule of the same events;
    the served order differs (arrival order against the schedule), so the
    losses are only held finite."""
    import re

    from repro_torch.core import async_sim
    from repro_torch.launch import cluster as launcher

    trace_dir = ROOT / "build" / "phase_d4_trace"
    out = _run_launcher("D4", "repro_torch.launch.cluster",
                        D4_FLAGS + ["--trace-dir", str(trace_dir)], env)
    events = re.search(r"\] (\d+) events in .*\| loss (\S+) -> (\S+)", out)
    wire_bytes = re.search(r"measured wire bytes: up=(\d+) .* down=(\d+) ",
                           out)
    if events is None or wire_bytes is None:
        raise AssertionError("D4: the launcher printed no events or bytes")
    if not all(np.isfinite(float(x)) for x in events.groups()[1:]):
        raise AssertionError(f"D4: losses {events.groups()[1:]}")
    _log_spans("D4 TCP", *_trace_spans(trace_dir), int(events.group(1)))

    args = launcher.parse_args(D4_FLAGS)
    params0, grad_fn, batch_fn, _ = launcher.problem(args)
    tr = async_sim.AsyncTrainer(
        launcher.strategy(args), grad_fn, args.clients, lr=args.lr,
        secondary_density=args.secondary_density,
        secondary_spec=launcher.secondary_spec(args), device=args.device)
    sched = np.tile(np.arange(args.clients), args.rounds)
    _, hist, _, _ = _cluster_run(torch, "D4 in-process", tr, params0, sched,
                              batch_fn, ROOT / "build" / "phase_d4i_trace")
    got = (int(events.group(1)), int(wire_bytes.group(1)),
           int(wire_bytes.group(2)))
    want = (len(hist.losses), hist.up_bytes, hist.down_bytes)
    if got != want or not np.isfinite(hist.losses).all():
        raise AssertionError(f"D4: TCP events and bytes {got} != in-process "
                             f"{want}")
    log(f"  D4: TCP events and bytes equal the in-process run's: {got}")


# ---------------------------------------------------------------------------
# phase F: serving and delta checkpoints at full width
# ---------------------------------------------------------------------------

def _restore_equal(torch, label, ckpt_dir, want, version):
    """Restore the chain on the card, time it, and hold it equal
    (``torch.equal``, the chain's contract) to ``want`` at ``version``."""
    from repro_torch.checkpoint import load_delta_checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arena, got, _ = load_delta_checkpoint(ckpt_dir)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if got != version or not torch.equal(arena, want):
        raise AssertionError(f"{label}: the restored chain (version {got}) "
                             f"!= the final arena (version {version})")
    log(f"  {label}: restored on the card in {dt:.3f} s, equal to the "
        f"final arena, version {got}")


# F3: the fleet launcher at phase B's widths and density
F3_FLAGS = ["--hidden", "2048,2304,2048", "--features", "512",
            "--classes", "10", "--batch-size", "8", "--density", "0.001",
            "--quantize", "int8", "--secondary-density", "0.001",
            "--push-density", "0.001", "--clients", "4", "--rounds", "8",
            "--replicas", "2", "--ckpt-every", "8", "--timeout", "120"]


def phase_f(torch, results, ref):
    """The serve leg and delta checkpoints at full width.  F1: phase D1's
    run with two replica threads and a checkpoint chain, bit-equal to phase
    B; F2: the serve launcher's ``--smoke``; F3: the fleet launcher at
    phase B's widths."""
    import shutil

    from repro_torch.checkpoint import (compact, load_delta_checkpoint,
                                        read_manifest)
    from repro_torch.cluster.subscribe import SubscriberBook
    from repro_torch.core.engine import CompressionSpec
    from repro_torch.models.mlp import MLP

    if "d1_launches" not in ref:
        raise AssertionError("phase D left no D1 run to hold phase F1 to")
    space, params0, sched, batch_fn, tr = _full_width(torch)
    cap = FULL_CAP
    # the replicas' decode: the MLP's accuracy on a 512-sample eval set
    model = MLP(FULL_DIMS, device="cuda")
    erng = np.random.default_rng(5)
    x, y = _blobs(erng, erng.normal(size=(10, 512)), 512, 1.0)
    eval_set = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    accs = []

    def decode_fn(params, step):
        accs.append(model.accuracy(params, eval_set))

    ckpt_dir = ROOT / "build" / "phase_f_ckpt"
    trace_dir = ROOT / "build" / "phase_f1_trace"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    push_spec = CompressionSpec(engine="blockwise", quantize="int8",
                                block_r=32)
    final, hist, launches, eps = _cluster_run(
        torch, "F1", tr, params0, sched, batch_fn, trace_dir, n_replicas=2,
        push_density=0.001, push_spec=push_spec, max_staleness=4,
        replica_decode_fn=decode_fn, ckpt_dir=ckpt_dir, ckpt_every=8)
    log(f"  F1: {eps:.2f} events/s against D1's {ref['d1_events_s']:.2f} in "
        f"this run")
    _same_run(torch, "F1", final, hist, ref["final"], ref["hist"])
    log("  F1 training bit-equal to phase B: losses, worker ids, staleness, "
        "final params, up and down bytes")

    final_arena = space.pack({k: t.cuda() for k, t in final.items()})
    cnt = hist.metrics["counters"]
    replicas = hist.metrics["replicas"]
    for i, r in enumerate(replicas):
        if r["version"] != cap or not torch.equal(
                r["arena"].view(torch.int32), final_arena.view(torch.int32)):
            raise AssertionError(f"F1: replica {i} (version {r['version']}) "
                                 f"!= the server's final arena")
        log(f"  F1 replica {i}: pushes {cnt[f'sub/{i}/pushes']:.0f} (the "
            f"SYNC included), push bytes {cnt[f'sub/{i}/push_bytes']:.0f}, "
            f"lag_max {cnt[f'sub/{i}/lag_max']:.0f}, stale_waits "
            f"{r['stale_waits']}, decodes {r['decodes']}, diffs applied "
            f"{r['diffs']}, version {r['version']}")
    log(f"  F1: both replicas bit-equal to the server's final arena; decode "
        f"accuracy {accs[0]:.3f} -> {accs[-1]:.3f} over {len(accs)} decodes")

    # the launches the pushes alone need: one segmented quantize a push,
    # a top-k a leaf a push (the block top-k, or its row regime for a leaf
    # of at most ROW_MAX elements), a flat scatter-add a push's commit and
    # an applied diff's; the rest of the run is D1's
    pushes = sum(cnt[f"sub/{i}/pushes"] - 1 for i in range(len(replicas)))
    applied = sum(r["diffs"] for r in replicas)
    need = {"segment_quantize": pushes,
            "block_topk+row_topk": space.n_leaves * pushes,
            "scatter_add": pushes + applied}
    extra = {k: sum(launches[n] - ref["d1_launches"][n]
                    for n in k.split("+")) for k in need}
    if any(extra[k] < need[k] for k in need):
        raise AssertionError(f"F1: launches beyond D1's {extra}, the pushes "
                             f"need at least {need}")
    log(f"  F1: {pushes} diff pushes, {applied} diffs applied; launches "
        f"beyond D1's {extra} (the pushes need {need}; per push "
        + ", ".join(f"{k} {extra[k] / pushes:.3f}" for k in need) + ")")
    spans, _ = _trace_spans(trace_dir)
    log(f"  F1 host ms per push {spans['coord/push'] / pushes:.3f}, per "
        f"SYNC {spans['coord/sync'] / len(replicas):.3f}, per append "
        f"{spans['coord/ckpt'] / cnt['ckpt_deltas']:.3f}, per applied diff "
        f"{spans['replica/apply'] / applied:.3f}, per decode "
        f"{spans['replica/decode'] / len(accs):.3f}")
    # one push alone, off the run (no training or replica threads): the
    # push's own cost, synchronized
    book = SubscriberBook(space, push_density=0.001, push_spec=push_spec)
    book.add(0)
    M = final_arena - space.pack(params0)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        book.diff_payload(0, M, cap, False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"  F1 one push alone, synchronized: the catch-up {times[0]:.3f} "
        f"ms, then {statistics.median(times[1:]):.3f} ms (median of 5)")
    del book, M

    manifest = read_manifest(ckpt_dir)
    n = len(manifest["deltas"])
    delta_bytes = (ckpt_dir / "deltas.bin").stat().st_size
    if n != cnt["ckpt_deltas"] or delta_bytes != cnt["ckpt_bytes"]:
        raise AssertionError(f"F1: {n} deltas of {delta_bytes} bytes on "
                             f"disk, counters {cnt['ckpt_deltas']} and "
                             f"{cnt['ckpt_bytes']}")
    log(f"  F1 checkpoint: {n} deltas, {delta_bytes} bytes (k: "
        f"{[e['k'] for e in manifest['deltas']]}), versions "
        f"{[e['version'] for e in manifest['deltas']]}")
    _restore_equal(torch, "F1 chain", ckpt_dir, final_arena, cap)
    compact(ckpt_dir, upto=n // 2)
    _restore_equal(torch, f"F1 chain compacted at {n // 2}", ckpt_dir,
                   final_arena, cap)
    del final, final_arena, replicas, hist

    env = _child_env()
    # F2: the serve launcher's smoke (1 client, 2 replica processes, a
    # checkpoint directory) on the card
    _run_launcher("F2", "repro_torch.launch.serve",
                  ["--smoke", "--out-dir", str(ROOT / "build" / "phase_f2"),
                   "--timeout", "120"], env)

    # F3: the fleet launcher at phase B's widths: replicas' arenas and the
    # restored chain equal, the chain's last version the run's 32 events
    out_dir, f3_ckpt = ROOT / "build" / "phase_f3", ROOT / "build" / "f3_ckpt"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(f3_ckpt, ignore_errors=True)
    _run_launcher("F3", "repro_torch.launch.serve",
                  F3_FLAGS + ["--out-dir", str(out_dir), "--ckpt-dir",
                              str(f3_ckpt)], env)
    arenas = [np.load(out_dir / f"replica_{i}.npy") for i in range(2)]
    chain = load_delta_checkpoint(f3_ckpt)[0].cpu().numpy()
    last = read_manifest(f3_ckpt)["deltas"][-1]["version"]
    if not (np.array_equal(arenas[0], arenas[1])
            and np.array_equal(arenas[0], chain)) or last != 32:
        raise AssertionError(f"F3: replica arenas and the restored chain "
                             f"differ, or the chain ends at version {last}")
    log("  F3: replica_0, replica_1 and the restored chain equal; the "
        "chain's last version 32")


# ---------------------------------------------------------------------------
# phase G: the sharded and mesh parameter servers at full width
# ---------------------------------------------------------------------------

def _shard_counters(label, hist, spec, n_events):
    """Every shard saw every event and holds its share of the arena."""
    cnt = hist.metrics["counters"]
    for s, size in enumerate(spec.sizes):
        got = (cnt[f"shard/{s}/events"], cnt[f"shard/{s}/arena_elems"])
        if got != (n_events, size):
            raise AssertionError(f"{label}: shard {s} counters {got}, "
                                 f"expected {(n_events, size)}")
    log(f"  {label}: every shard's events {n_events}, arena_elems "
        f"{list(spec.sizes)}")


def phase_g(torch, results, ref):
    """The sharded parameter servers at full width, S = 4: G1 the S-thread
    runtime and G2 the mesh server, both held to phase D1; G3 the TCP
    launcher's sharded and mesh runs held to its 1-shard lockstep run."""
    from repro_torch.cluster import wire
    from repro_torch.core import server as ps
    from repro_torch.core.paramspace import ShardSpec

    if "d1_events_s" not in ref:
        raise AssertionError("phase D left no D1 run to hold phase G to")
    space, params0, sched, batch_fn, tr = _full_width(torch)
    cap, d1 = FULL_CAP, ref["d1_events_s"]
    spec = ShardSpec.for_space(space, G_SHARDS)
    log(f"  shards: bounds {spec.bounds}, sizes {spec.sizes}, mesh width "
        f"{ps.mesh_width(spec)}")

    # G1: S coordinator threads, each UP fanned out as S frames
    final, hist, launches, eps = _cluster_run(
        torch, "G1", tr, params0, sched, batch_fn,
        ROOT / "build" / "phase_g1_trace", n_shards=G_SHARDS)
    log(f"  G1: {eps:.2f} events/s against D1's {d1:.2f} in this run")
    _same_run(torch, "G1", final, hist, ref["final"], ref["hist"],
              check_bytes=False)
    seg = space.ks(0.001)
    want = tuple(cap * sum(wire.shard_frame_bytes_static(spec, seg, mode))
                 for mode in ("int8", "none"))
    if (hist.up_bytes, hist.down_bytes) != want:
        raise AssertionError(f"G1: bytes {hist.up_bytes, hist.down_bytes} "
                             f"!= the per-shard static frames {want}")
    _shard_counters("G1", hist, spec, cap)
    framed = sum(1 for size in spec.sizes if size)
    if launches["segment_quantize"] != 2 * framed * cap:
        raise AssertionError(f"G1: the segmented quantize launched "
                             f"{launches['segment_quantize']}, expected "
                             f"{2 * framed * cap} (an UP and a DOWN frame "
                             f"per shard that is not empty, per event)")
    log(f"  G1 bit-equal to D1: losses, worker ids, staleness, final params; "
        f"bytes {want} = {cap} x the per-shard static frames (D1: "
        f"{ref['hist'].up_bytes, ref['hist'].down_bytes})")
    del final, hist

    # G2: one mesh coordinator, the S arenas stacked on the card
    final, hist, launches, eps = _cluster_run(
        torch, "G2", tr, params0, sched, batch_fn,
        ROOT / "build" / "phase_g2_trace", mesh_shards=G_SHARDS)
    log(f"  G2: {eps:.2f} events/s against D1's {d1:.2f} in this run")
    _same_run(torch, "G2", final, hist, ref["final"], ref["hist"])
    overflow = hist.metrics["counters"]["route_overflow"]
    if overflow != 0:
        raise AssertionError(f"G2: route_overflow {overflow}")
    _shard_counters("G2", hist, spec, cap)
    if launches["segment_quantize"] != 2 * cap:
        raise AssertionError(f"G2: the segmented quantize launched "
                             f"{launches['segment_quantize']}, expected "
                             f"{2 * cap}, as D1")
    log("  G2 bit-equal to D1: losses, worker ids, staleness, final params, "
        "up and down bytes; route_overflow 0")
    del final, hist
    torch.cuda.empty_cache()
    phase_g3(torch)


def phase_g3(torch):
    """The TCP launcher's coordinator side (``launch.cluster.serve_cluster``
    here, on the card) at phase B's widths with 4 client processes: a
    1-shard lockstep run, ``--shards 4`` and ``--mesh-shards 4``, each
    sharded run bit-equal to the lockstep one (the mesh run's bytes
    too)."""
    import os

    from repro_torch import kernels
    from repro_torch.launch import cluster as launcher
    from repro_torch.telemetry import Recorder

    args = launcher.parse_args(D4_FLAGS)
    params0, _, _, _ = launcher.problem(args)
    saved = dict(os.environ)
    os.environ.update(_child_env())      # the client processes' PYTHONPATH
    runs = {}
    try:
        for label, tag, kw in (
                ("G3 1-shard lockstep", "lockstep", dict(lockstep=True)),
                ("G3 --shards 4", "shards", dict(n_shards=G_SHARDS)),
                ("G3 --mesh-shards 4", "mesh", dict(mesh_shards=G_SHARDS))):
            trace_dir = ROOT / "build" / f"phase_g3_{tag}_trace"
            rec = Recorder(trace_dir)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            final, hist, dt = launcher.serve_cluster(
                args, params0, spawn_clients=True, recorder=rec, **kw)
            torch.cuda.synchronize()
            launches = {info.name: info.launches
                        for info in kernels.KERNELS}
            rec.close()
            n = len(hist.losses)
            log(f"  {label}: {n} events in {dt:.3f} s, {n / dt:.2f} events/s "
                f"(client processes' start-up included); up "
                f"{hist.up_bytes} B, down {hist.down_bytes} B")
            log(f"  {label}: the coordinators' launches per event "
                f"{ {k: v / n for k, v in launches.items()} }")
            log(f"  {label}: peak device memory (coordinator process) "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            _log_spans(label, *_trace_spans(trace_dir), n)
            runs[label] = (final, hist)
            del final
            torch.cuda.empty_cache()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    want_final, want = runs.pop("G3 1-shard lockstep")
    if len(want.losses) != args.clients * args.rounds \
            or not np.all(np.isfinite(want.losses)):
        raise AssertionError(f"G3: the lockstep run served "
                             f"{len(want.losses)} events")
    for label, (final, hist) in runs.items():
        _same_run(torch, label, final, hist, want_final, want,
                  check_bytes="mesh" in label)
    log("  G3: --shards 4 bit-equal to the 1-shard lockstep run (losses, "
        "worker ids, staleness, final params), --mesh-shards 4 too, bytes "
        "included")


# ---------------------------------------------------------------------------
# phase H: the data-parallel training path, the mesh exchanges
# ---------------------------------------------------------------------------

H_W = 4                     # workers: lanes of the card
H_BATCH, H_SEQ, H_STEPS = 16, 128, 5
H_LR, H_MOMENTUM, H_DENSITY = 0.05, 0.9, 0.05
H_LAYERS = 2                # of chatglm3-6b's 28; H3 at 1
# the kernel rows every allgather-blockwise exchange must launch: rows 1,
# 2, 3r (its row regime: every row fits a CTA; the norm scales' flat step),
# 4 and 4a; H1 adds 3s, which takes chatglm3's hinted rows
H_ROWS = ("scatter_add", "scatter_add_rows", "row_topk",
          "samomentum_fused", "samomentum_accumulate")


def _h_cfg(n_layers: int):
    """chatglm3-6b at its published widths, ``n_layers`` deep."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("chatglm3-6b"), n_layers=n_layers)


def _h_exchange(mode: str, **kw):
    from repro_torch.core.distributed import ExchangeConfig

    return ExchangeConfig(mode=mode, density=H_DENSITY, momentum=H_MOMENTUM,
                          engine="blockwise", **kw)


def _h_run(torch, label, cfg, mesh, ex_cfg, stream, steps, card):
    """``steps`` train steps from the seed-0 parameters, each split into
    gradients, exchange and update by CUDA events.  Returns (params,
    state, losses, launches, step)."""
    from repro_torch import kernels
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.launch.roofline import wire_bytes
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params

    step = build_train_step(cfg, mesh, ex_cfg, lr=H_LR, remat=False)
    params = init_params(cfg, seed=0, device=mesh.device)
    state = step.init_state(params)
    batches = [stream.batch(i) for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, split, walls = [], [], []
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        grads, lane_losses = step.grads(params, batches[i])
        ev[1].record()
        updates, state = step.exchange(state, grads)
        ev[2].record()
        del grads
        step.apply(params, updates)
        ev[3].record()
        del updates
        loss = float(mesh.mean(lane_losses))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        losses.append(loss)
    launches = {info.name: info.launches for info in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    tokens = stream.batch_size * stream.seq_len
    steady = statistics.median(walls[1:]) if steps > 1 else walls[0]
    log(f"  {label} [{card}]: losses {[round(x, 5) for x in losses]}")
    for i, ((g, x, u), w) in enumerate(zip(split, walls)):
        log(f"  {label} step {i}: gradients {g:.2f} ms, exchange {x:.2f} ms, "
            f"update {u:.2f} ms (CUDA events); wall {w * 1e3:.2f} ms")
    log(f"  {label}: {tokens / steady:.1f} tokens/s (median step of 1-"
        f"{steps - 1}, {steady * 1e3:.2f} ms), {steps * tokens / sum(walls):.1f}"
        f" tokens/s all in; peak device memory {peak / 2**30:.2f} GiB "
        f"[{card}]")
    log(f"  {label}: launches per step "
        f"{ {k: v / steps for k, v in launches.items()} }")
    shapes = [p.shape for p in tree_leaves(params)]
    log(f"  {label}: wire bytes per worker and step "
        f"{wire_bytes(step.ex_cfg, step.mesh.size, shapes, step.hints)} "
        f"(static k's)")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    for p in tree_leaves(params):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{label}: non-finite parameter")
    if isinstance(state.overflow, torch.Tensor):
        log(f"  {label}: overflow per lane {state.overflow.tolist()} over "
            f"{steps} steps (bucket_factor {step.ex_cfg.bucket_factor})")
    batch = stream.batch(steps)
    _profile(torch, label, lambda: step(params, state, batch))
    return params, state, losses, launches, step


def _profile(torch, label, fn):
    """One more call of ``fn`` (a step) under the profiler, after the
    launches were read: the device's busy time and share of the step, and
    its costliest device rows (kernels, copies, fills)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(a.self_device_time_total, a.count, a.key)
            for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA
            and a.self_device_time_total > 0]
    busy_us = sum(t for t, _, _ in rows)
    if busy_us == 0:
        log(f"  {label} profiler: no device time recorded (busy share not "
            f"measured)")
        return
    log(f"  {label} profiler, one step: device busy {busy_us / 1e3:.2f} ms "
        f"of {wall * 1e3:.2f} ms wall ({busy_us / 1e6 / wall:.3f} busy "
        f"share), {sum(c for _, c, _ in rows)} device kernels and copies")
    for t, c, key in sorted(rows, reverse=True)[:8]:
        log(f"    {t / 1e3:8.2f} ms  x{c:<5d} {key[:80]}")


def phase_h(torch, results, card):
    """The data-parallel training path: H1 chatglm3-6b at full width (2 of
    its 28 layers) on 4 lanes of the card in all three modes, and the
    shardedps identity; H2 the card against the CPU; H3 one worker per
    process (two on the card, gloo) against the lanes, and the route over
    ranks; H4 the launcher."""
    phase_h1(torch, results, card)
    torch.cuda.empty_cache()
    phase_h2(torch)
    torch.cuda.empty_cache()
    phase_h3(torch)
    torch.cuda.empty_cache()
    out = _run_launcher("H4", "repro_torch.launch.train", ["--steps", "5"],
                        _child_env())
    # --devices 8 by default: the reference's (4 data, 2 model) mesh
    if "mesh={'data': 4, 'model': 2}" not in out:
        raise AssertionError("H4: the launcher did not train the (4, 2) "
                             "mesh")


def phase_h1(torch, results, card):
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.models.model import abstract_params

    cfg = _h_cfg(H_LAYERS)
    mesh = LaneMesh(H_W, "cuda")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                         batch_size=H_BATCH, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(abstract_params(cfg)))
    log(f"  H1: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_layers} layers: {n_params} parameters; "
        f"W = {H_W} lanes, batch {H_BATCH} x seq {H_SEQ}")
    for mode in ("allgather", "shardedps", "dense"):
        label = f"H1 {mode}"
        params, state, _, launches, _ = _h_run(
            torch, label, cfg, mesh, _h_exchange(mode), stream, H_STEPS,
            card)
        for row in results:
            row[f"launches_h_{mode}"] = launches[row["name"]]
        if mode == "allgather":
            idle = [k for k in H_ROWS + ("samomentum_row_topk",)
                    if launches[k] == 0]
            if idle:
                raise AssertionError(f"{label}: rows {idle} never launched: "
                                     f"{launches}")
        del params, state
        torch.cuda.empty_cache()
    h1_identity(torch, cfg, mesh, stream)


def h1_identity(torch, cfg, mesh, stream):
    """One step at full width: with a bucket for every entry and a dense
    downward pass, shardedps gives the allgather update and velocity and
    M == v on every shard (atol 1e-5).  The allgather results wait on the
    host while shardedps runs."""
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params

    params = init_params(cfg, seed=0, device="cuda")
    ag = build_train_step(cfg, mesh, _h_exchange("allgather"), lr=H_LR,
                          remat=False)
    grads, _ = ag.grads(params, stream.batch(0))
    st = ag.init_state(params)
    upd, st = ag.exchange(st, grads)
    want_u = [x.cpu() for x in tree_leaves(upd)]
    want_v = [x.cpu() for x in tree_leaves(st.velocity)]
    del upd, st
    torch.cuda.empty_cache()
    sp = build_train_step(cfg, mesh, _h_exchange(
        "shardedps", bucket_factor=float(H_W), secondary_density=1.0),
        lr=H_LR, remat=False)
    st = sp.init_state(params)
    upd, st = sp.exchange(st, grads)
    del grads
    worst = [0.0, 0.0, 0.0]
    for i, (u, v) in enumerate(zip(tree_leaves(upd), tree_leaves(st.velocity))):
        worst[0] = max(worst[0], float((u - want_u[i].cuda()).abs().max()))
        worst[1] = max(worst[1], float((v - want_v[i].cuda()).abs().max()))
    for m, v in zip(tree_leaves(st.m_shard), tree_leaves(st.v_shard)):
        worst[2] = max(worst[2], float((m - v).abs().max()))
    log(f"  H1 identity: shardedps (bucket_factor {H_W}, secondary 1.0) vs "
        f"allgather, max |diff|: update {worst[0]:.3g}, velocity "
        f"{worst[1]:.3g}, M - v {worst[2]:.3g}; overflow "
        f"{st.overflow.tolist()}")
    if max(worst) > 1e-5 or int(st.overflow.sum()) != 0:
        raise AssertionError(f"H1 identity fails: {worst}")


H_TIE = 1e-5     # how near a support swap lies to its row's boundary


def _tie_gaps(torch, step, velocity, grads, *, lanes: bool = False):
    """Per leaf, each coordinate's distance from its row's selection
    boundary on its closest lane, relative to the row's k-th magnitude:
    with ``a`` the coordinate's ``|m * u + lr * g|`` and ``t_k >= t_k1``
    the row's k_row-th and (k_row + 1)-th such magnitudes, 0 where ``t_k1
    <= a <= t_k`` and otherwise how far ``a`` lies outside, over ``t_k``
    (inf where the row selects every coordinate).  A coordinate that two
    runs select differently although their accumulations differ by
    rounding alone lies within that rounding of the boundary.  With
    ``lanes`` each leaf's entry is instead a pair of ``(L, *shape)``
    arrays: every lane's distance and ``a``."""
    from repro_torch.core.distributed import leaf_cut
    from repro_torch.core.engine import velocity_accumulate
    from repro_torch.core.paramspace import tree_leaves

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
            accs.append(a.cpu().numpy())
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
                        .cpu().numpy())
        gaps = np.stack(gaps)
        out.append((gaps, np.stack(accs)) if lanes else gaps.min(0))
    return out


def _h2_setup(torch):
    """H2's problem: the reduced chatglm3 with float32 compute, its seed-0
    parameters and H_STEPS batches as numpy."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.paramspace import tree_flatten
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_arch("chatglm3-6b").reduced(),
                              compute_dtype="float32")
    leaves, paths = tree_flatten(init_params(cfg, seed=0, device="cpu"))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                         batch_size=H_BATCH, seed=0, device="cpu")
    batches = [stream.batch(i)["tokens"].numpy() for i in range(H_STEPS)]
    return cfg, paths, [x.numpy() for x in leaves], batches


def _h2_params(torch, paths, leaves_np, dev):
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.paramspace import tree_unflatten

    return params_from_numpy(tree_unflatten(paths, list(leaves_np)), dev)


def phase_h2(torch):
    """The reduced chatglm3 with float32 compute on 4 lanes, the card
    against the CPU from the same numpy weights and batches.

    H2a, the exact engine end to end: 5 allgather steps on each device,
    losses to rtol 1e-4, parameters to atol 1e-5 but at support swaps.  A
    coordinate outside the atol must be one: a step of one run moved it and
    the same step of the other did not, and at that step it lay within
    ``H_TIE`` (relative) of its row's selection boundary on the CPU's side
    (the card's accumulation differs by rounding alone), at most one
    coordinate in 10,000.

    H2b, the blockwise exchange (rows 1-4, 4a, 4b) against the CPU's plain
    versions: 5 allgather steps on the CPU, and on the card the exchange
    and update alone, fed the CPU's gradients each step.  Parameters and
    velocities must be equal bit for bit."""
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.core.paramspace import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_train_step

    cfg, paths, leaves_np, batches = _h2_setup(torch)

    def flat(tree):
        return [x.cpu().numpy().copy() for x in tree_flatten(tree)[0]]

    ex_cfg = ExchangeConfig(mode="allgather", density=H_DENSITY,
                            momentum=H_MOMENTUM, engine="exact")
    out, tie = {}, None
    for dev in ("cuda", "cpu"):
        step = build_train_step(cfg, LaneMesh(H_W, dev), ex_cfg, lr=H_LR,
                                remat=False)
        params = _h2_params(torch, paths, leaves_np, dev)
        state = step.init_state(params)
        losses, runs, gaps = [], [flat(params)], []
        t0 = time.perf_counter()
        for b in batches:
            batch = {"tokens": torch.from_numpy(b).to(dev)}
            if dev == "cpu":    # the gradients the step computes
                gaps.append(_tie_gaps(torch, step, state.velocity,
                                      step.grads(params, batch)[0]))
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
            runs.append(flat(params))
        log(f"  H2a {dev}: losses {[round(x, 6) for x in losses]} "
            f"({time.perf_counter() - t0:.2f} s)")
        out[dev] = (losses, runs)
    (lg, rg), (lc, rc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    excused = total = swaps = 0
    worst_in = worst_tie = 0.0
    for j, path in enumerate(paths):
        swapped = np.zeros(rg[0][j].shape, bool)
        tie = np.full(rg[0][j].shape, np.inf)
        for i in range(H_STEPS):
            new = (((rg[i][j] != rg[i + 1][j]) ^ (rc[i][j] != rc[i + 1][j]))
                   & ~swapped)
            tie[new] = gaps[i][j][new]
            swapped |= new
        diff = np.abs(rg[-1][j] - rc[-1][j])
        bad = diff > 1e-5
        if not swapped[bad].all() or not (tie[bad] <= H_TIE).all():
            raise AssertionError(
                f"H2a: {'/'.join(path)}: {int(bad.sum())} parameters "
                f"outside atol 1e-5 (max {float(diff.max())}), of which "
                f"{int((~swapped[bad]).sum())} moved by both runs; their "
                f"distances from the boundary {tie[bad].tolist()[:8]}")
        excused += int(bad.sum())
        swaps += int(swapped.sum())
        total += diff.size
        worst_in = max(worst_in, float(diff[~bad].max(initial=0.0)))
        worst_tie = max(worst_tie, float(tie[bad].max(initial=0.0)))
    log(f"  H2a: card and CPU agree: losses rtol 1e-4; parameters max |diff| "
        f"{worst_in:.3g} but at {excused} support swaps of {total} "
        f"parameters (each within {worst_tie:.3g} of its row's boundary; "
        f"{swaps} coordinates moved by one run only, the rest within the "
        f"atol)")
    if excused > total // 10_000:
        raise AssertionError(f"H2a: {excused} support swaps")

    # H2b: the blockwise exchange on the card fed the CPU's gradients
    ex_cfg = ExchangeConfig(mode="allgather", density=H_DENSITY,
                            momentum=H_MOMENTUM, engine="blockwise")
    steps = {dev: build_train_step(cfg, LaneMesh(H_W, dev), ex_cfg,
                                   lr=H_LR, remat=False)
             for dev in ("cuda", "cpu")}
    params = {dev: _h2_params(torch, paths, leaves_np, dev)
              for dev in steps}
    state = {dev: steps[dev].init_state(params[dev]) for dev in steps}
    for b in batches:
        grads, _ = steps["cpu"].grads(params["cpu"],
                                      {"tokens": torch.from_numpy(b)})
        g_leaves, g_paths = tree_flatten(grads)
        for dev, step in steps.items():
            g = tree_unflatten(g_paths, [x.to(dev) for x in g_leaves])
            updates, state[dev] = step.exchange(state[dev], g)
            step.apply(params[dev], updates)
    for label, a, c in (
            ("parameters", flat(params["cuda"]), flat(params["cpu"])),
            ("velocities", flat(state["cuda"].velocity),
             flat(state["cpu"].velocity))):
        bad = [("/".join(p), int((x.view(np.int32) != y.view(np.int32))
                                 .sum()))
               for p, x, y in zip(paths, a, c)
               if not np.array_equal(x.view(np.int32), y.view(np.int32))]
        if bad:
            raise AssertionError(f"H2b: {label} differ: {bad}")
    log(f"  H2b: the blockwise exchange on the card fed the CPU's gradients: "
        f"parameters and velocities bit-equal to the CPU's after {H_STEPS} "
        f"steps")


def _digests(torch, tensors) -> list:
    """SHA-256 of each tensor's bytes (bit equality without a copy of the
    other side's tensors)."""
    import hashlib

    return [hashlib.sha256(t.detach().contiguous().view(-1)
                           .view(torch.uint8).cpu().numpy()).hexdigest()
            for t in tensors]


def _h3_route_problem():
    """16 messages of phase B's size (k = 10,514 global indices into its
    10,512,650-element arena, -0 planted) and the arena's 2-shard spec."""
    import torch

    from repro_torch.core.paramspace import ShardSpec

    space = full_width_space(torch)
    rng = np.random.default_rng(23)
    k = sum(space.ks(0.001))
    idx = np.stack([rng.permutation(space.total)[:k] for _ in range(G_BATCH)]
                   ).astype(np.int32)
    vals = rng.normal(size=(G_BATCH, k)).astype(np.float32)
    vals[:, ::9] = -0.0
    return (ShardSpec.for_space(space, 2), torch.from_numpy(idx).cuda(),
            torch.from_numpy(vals).cuda())


def _h3_train(torch, mesh, steps):
    """H3's problem on ``mesh``: chatglm3-6b at full width, 1 layer,
    allgather-blockwise.  Returns (losses, parameter digests)."""
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params

    cfg = _h_cfg(1)
    step = build_train_step(cfg, mesh, _h_exchange("allgather"), lr=H_LR,
                            remat=False)
    params = init_params(cfg, seed=0, device="cuda")
    state = step.init_state(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                         batch_size=4 * mesh.size, seed=0, device="cuda")
    losses = []
    for i in range(steps):
        params, state, loss = step(params, state, stream.batch(i))
        losses.append(float(loss))
    return losses, _digests(torch, tree_leaves(params))


def h3_rank(rank: int, world: int, init_method: str, out: str) -> None:
    """One rank of H3 (run by ``phase_h3`` in a process of its own): the
    training problem and the route over a ProcessMesh; writes JSON."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import distributed
    from repro_torch.launch.mesh import init_process_mesh

    mesh = init_process_mesh(rank, world, init_method, "cuda")
    t0 = time.perf_counter()
    losses, digests = _h3_train(torch, mesh, 3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    spec, idx, vals = _h3_route_problem()
    ri, rv, ovf = distributed.shard_exchange_batch(spec, idx, vals,
                                                   use_mesh=True, mesh=mesh)
    Path(out).write_text(json.dumps(dict(
        losses=losses, digests=digests, seconds=dt, peak=peak,
        staged=mesh.staged, route=_digests(torch, [ri, rv]),
        overflow=int(ovf))))
    torch.distributed.destroy_process_group()


def phase_h3(torch):
    """Two processes on the one card, a ProcessMesh over gloo with staged
    operands, 3 allgather steps of chatglm3-6b at full width, 1 layer: each
    rank's parameters bit-equal to the other's and to an in-process
    LaneMesh(2) run; then the route of 16 phase B messages at S = 2 over
    the ranks (``use_mesh=True``) bit-equal to the one-card leg."""
    import tempfile

    from repro_torch.core import distributed
    from repro_torch.launch.mesh import LaneMesh

    world = 2
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
             " chip_smoke.h3_rank(int(sys.argv[2]), int(sys.argv[3]), "
             "sys.argv[4], sys.argv[5])", str(ROOT), str(r), str(world),
             f"file://{tmp}/rendezvous", f"{tmp}/rank{r}.json"],
            cwd=ROOT, env=_child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=400)[0])
        finally:
            for proc in procs:
                proc.kill()
        for r, (proc, text) in enumerate(zip(procs, outs)):
            if proc.returncode != 0:
                for line in text.strip().splitlines()[-15:]:
                    log(f"  H3 rank {r} | {line}")
                raise AssertionError(f"H3: rank {r} exited {proc.returncode}")
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
                 for r in range(world)]
    log(f"  H3: {world} ranks in {time.perf_counter() - t0:.1f} s (process "
        f"start-up included), staged {[r['staged'] for r in ranks]}; train "
        f"{[round(r['seconds'], 2) for r in ranks]} s; peak "
        f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB a rank")
    torch.cuda.reset_peak_memory_stats()
    losses, digests = _h3_train(torch, LaneMesh(world, "cuda"), 3)
    log(f"  H3 lanes: losses {losses}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for r, got in enumerate(ranks):
        if got["digests"] != digests or got["losses"] != losses:
            raise AssertionError(f"H3: rank {r} differs from the lanes: "
                                 f"losses {got['losses']} vs {losses}")
    log("  H3: both ranks' parameters bit-equal to each other's and to the "
        "LaneMesh(2) run (SHA-256 of every leaf), losses equal")
    spec, idx, vals = _h3_route_problem()
    ri, rv, ovf = distributed.shard_exchange_batch(spec, idx, vals)
    want = _digests(torch, [ri, rv])
    for r, got in enumerate(ranks):
        if got["route"] != want or got["overflow"] != int(ovf):
            raise AssertionError(f"H3: rank {r}'s route differs from the "
                                 f"one-card leg")
    log(f"  H3: the route over {world} ranks (use_mesh=True, 16 messages of "
        f"k = {idx.shape[1]}) bit-equal to the one-card leg on both ranks")


# ---------------------------------------------------------------------------
# phase I: prefill and KV-cache decode of the dense GQA family
# ---------------------------------------------------------------------------

I_BATCH, I_PROMPT, I_GEN = 16, 1024, 64      # I1: chatglm3-6b at full width
I_REPS = 10                                  # I2: timed steps a cell
# I2's cells: (arch, input shape, layers, batch cut); gemma3 runs one unit
# of its pattern (5 local layers, 1 global) at B 16 of 128, for memory
I2_CELLS = (("chatglm3-6b", "decode_32k", 2, None),
            ("chatglm3-6b", "long_500k", 2, None),
            ("gemma3-12b", "decode_32k", 6, 16))
I3_BATCH, I3_PROMPT, I3_STEPS = 4, 60, 16
I3_MARGIN = {"float32": 1e-3, "bfloat16": 5e-2}


def _cache_leaves(caches) -> list:
    """The tensors of a cache tree: dicts and cache named tuples."""
    if isinstance(caches, dict):
        return [t for c in caches.values() for t in _cache_leaves(c)]
    if isinstance(caches, tuple):
        return [t for c in caches for t in _cache_leaves(c)]
    return [caches]


def _cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for t in _cache_leaves(caches))


def _decode_bound(cfg, params, caches, batch, pos, long_mode, rate,
                  moe=None):
    """(bound ms, "bytes" or "operations") of one decode step: the larger
    of its bytes over the memory rate (every cache leaf and every parameter
    read once, the hybrid's shared block once a use, of an untied
    embedding only the batch's rows; the new K/V or latent rows, each SSM
    layer's state and conv window, and the float32 logits written once)
    and its operations over the peak rate of their type (the projections
    in the compute dtype and the head in its own, 2 flops a weight and
    token; the float32 scores and PV product over the positions the mask
    lets through; MLA without absorption expands those positions' latents
    through ``wkv_b`` in the compute dtype, with it multiplies the latents
    in float32; an SSM layer's float32 conv and state update).  For the
    MoE family ``moe`` is the step's routing, (experts with a kept pair,
    kept pairs), each summed over the layers: of the experts' weights only
    those experts' are read and only the kept pairs multiplied (the work
    this run's data needs); the router multiplies in float32."""
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.launch.roofline import PEAK_FLOPS
    from repro_torch.models.attention import _is_windowed

    pattern, n_units = cfg.unit_pattern()
    table = params["embed"]["table"].numel()
    weights = sum(p.numel() for p in tree_leaves(params)) - table
    if "shared" in params:       # read and multiplied once a use
        uses = n_units * pattern.count("mamba_attn")
        weights += (uses - 1) * sum(p.numel()
                                    for p in tree_leaves(params["shared"]))
    router = expert = per_expert = used = kept = 0
    if cfg.moe is not None:
        blocks = [params["units"][f"b{i}"]["moe"] for i in range(len(pattern))]
        router = sum(b["router"]["w"].numel() for b in blocks)
        expert = sum(b[key].numel() for b in blocks
                     for key in ("up", "gate", "down") if key in b)
        per_expert = expert // (cfg.n_layers * cfg.moe.n_experts)
        used, kept = moe
    el = cfg.cdtype.itemsize
    read = (4 * (weights - expert + used * per_expert) + _cache_bytes(caches)
            + 4 * (table if cfg.tie_embeddings else batch * cfg.d_model))
    wrote = 4 * batch * cfg.vocab_size
    attn = low = 0          # float32 and compute-dtype operations
    for kind in pattern:
        live = pos + 1
        if kind in ("mamba", "mamba_attn"):
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh, conv = d_in // s.head_dim, d_in + 2 * s.n_groups * s.d_state
            state = nh * s.head_dim * s.d_state
            wrote += n_units * batch * (4 * state + (s.d_conv - 1) * conv * el)
            attn += n_units * batch * (2 * s.d_conv * conv + 5 * state)
            if kind == "mamba_attn" and "shared" in params:
                wrote += n_units * 2 * batch * cfg.n_kv_heads * cfg.hd * el
                attn += n_units * 2 * 2 * batch * cfg.n_heads * live * cfg.hd
            continue
        if cfg.attention == "mla":
            m, H = cfg.mla, cfg.n_heads
            dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                             m.v_head_dim, m.kv_lora_rank)
            wrote += n_units * batch * (r + dr) * el
            if m.absorb:
                attn += n_units * 2 * batch * H * (
                    dn * r + live * (r + dr) + live * r + r * dv)
            else:
                low += n_units * 2 * batch * live * r * H * (dn + dv)
                attn += n_units * 2 * batch * H * live * (dn + dr + dv)
            continue
        if _is_windowed(cfg, kind, long_mode):
            live = min(live, cfg.window)
        wrote += n_units * 2 * batch * cfg.n_kv_heads * cfg.hd * el
        attn += n_units * 2 * 2 * batch * cfg.n_heads * live * cfg.hd
    # the tied head multiplies in float32 (``layers.unembed``)
    tied = 2 * batch * table if cfg.tie_embeddings else 0
    t_bytes = (read + wrote) / rate * 1e3
    t_ops = ((2 * batch * (weights - expert - router) + 2 * kept * per_expert
              + low) / PEAK_FLOPS[cfg.compute_dtype]
             + (tied + attn + 2 * batch * router) / PEAK_FLOPS["float32"]
             ) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_i(torch, card, rate):
    """Prefill and decode: I1 chatglm3-6b at full width (2 of 28 layers),
    I2 decode steps at the assigned decode shapes, I3 the card against the
    CPU on the reduced models, I4 the decode launcher.  No kernel of the
    port lies on this path: the launch counters are read and printed."""
    from repro_torch import kernels

    kernels.reset_launches()
    phase_i1(torch, card, rate)
    torch.cuda.empty_cache()
    phase_i2(torch, card, rate)
    torch.cuda.empty_cache()
    phase_i3(torch)
    torch.cuda.empty_cache()
    log(f"  I: kernel launches "
        f"{ {k.name: k.launches for k in kernels.KERNELS} } (no kernel on "
        f"the decode path)")
    phase_i4()


def phase_i1(torch, card, rate):
    _generate(torch, card, rate, _h_cfg(H_LAYERS), "I1")


def _generate(torch, card, rate, cfg, label, *, prompt_len=I_PROMPT,
              frontend_embeds=None):
    """``cfg`` prefills a B 16 x ``prompt_len`` prompt (1,024; a modality
    family's ``frontend_embeds`` in place of its first positions), then
    decodes 64 greedy tokens: prefill ms, ms a step by CUDA events,
    tokens/s, the bound, peak memory, one profiled step; the caches must
    be those of ``init_caches`` at the prompt and the tokens' length."""
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.models import decode_step, init_caches, init_params
    from repro_torch.models import prefill

    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    pattern, n_units = cfg.unit_pattern()
    log(f"  {label}: published widths (d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, mla {cfg.mla}, ssm {cfg.ssm}), {cfg.n_layers} "
        f"layers ({n_units} x {pattern}): {n_params} parameters "
        f"({4 * n_params} bytes); B {I_BATCH}, a prompt of {prompt_len}"
        + ("" if frontend_embeds is None else
           f" ({frontend_embeds.shape[1]} frontend embeddings, then "
           f"{prompt_len - frontend_embeds.shape[1]} tokens)")
        + f", {I_GEN} greedy tokens")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (I_BATCH, prompt_len)).astype(np.int32)).cuda()
    max_len = prompt_len + I_GEN
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = []
    for _ in range(2):      # the first call warms the matmuls up
        logits = caches = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, caches, _ = prefill(params, prompt, cfg, max_len=max_len,
                                    frontend_embeds=frontend_embeds)
        ev[1].record()
        torch.cuda.synchronize()
        prefill_ms.append(ev[0].elapsed_time(ev[1]))
    tokens = [logits[:, -1].argmax(-1)]
    finite = [torch.isfinite(logits).all()]
    events = []
    for t in range(I_GEN - 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, caches = decode_step(params, caches, tokens[-1][:, None],
                                     prompt_len + t, cfg)
        ev[1].record()
        events.append(ev)
        tokens.append(logits[:, 0].argmax(-1))
        finite.append(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # one more step at the last position, which it writes again (an SSM
    # state steps once more: the tokens are read above)
    _profile(torch, f"{label} decode", lambda: decode_step(
        params, caches, tokens[-1][:, None], max_len - 1, cfg))
    bound, bound_by = _decode_bound(cfg, params, caches, I_BATCH,
                                    max_len - 1, False, rate)
    step_ms = [a.elapsed_time(b) for a, b in events]
    step = statistics.median(step_ms)
    out = torch.stack(tokens, dim=1).cpu()
    want = _cache_bytes(init_caches(cfg, I_BATCH, max_len, device="meta"))
    log(f"  {label} [{card}]: prefill {prefill_ms[1]:.3f} ms (first call "
        f"{prefill_ms[0]:.3f}); decode {step:.3f} ms a step (median of steps "
        f"1-{I_GEN - 1}, CUDA events; range {min(step_ms):.3f}-"
        f"{max(step_ms):.3f}), {I_BATCH / step * 1e3:.1f} tokens/s; bound "
        f"{bound:.3f} ms ({bound_by}), {bound / step:.3f} of it; peak device "
        f"memory {peak / 2**30:.2f} GiB; caches {_cache_bytes(caches)} bytes")
    log(f"  {label}: sequence 0's first tokens {out[0, :12].tolist()}")
    if not all(bool(f) for f in finite):
        raise AssertionError(f"{label}: non-finite logits")
    if out.shape != (I_BATCH, I_GEN) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: tokens out of range, shape "
                             f"{out.shape}")
    if _cache_bytes(caches) != want:
        raise AssertionError(f"{label}: caches hold {_cache_bytes(caches)} "
                             f"bytes, not {want}")


def phase_i2(torch, card, rate):
    import dataclasses

    from repro_torch.configs import get_arch, get_shape

    for arch, shape_name, layers, batch in I2_CELLS:
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        shape = get_shape(shape_name)
        if batch is not None:
            shape = dataclasses.replace(shape, global_batch=batch)
        _decode_cell(torch, card, rate, f"I2 {arch} {shape_name}", cfg,
                     shape)
        torch.cuda.empty_cache()


def _decode_cell(torch, card, rate, label, cfg, shape):
    """``I_REPS`` timed serve steps of ``cfg`` at ``shape`` from its
    concrete inputs (zero caches, pos = seq_len // 2), after one that warms
    up; then one profiled step and the bound."""
    from repro_torch.configs import concrete_inputs
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import init_params
    from repro_torch.models.attention import KVCache

    step = build_serve_step(cfg, LaneMesh(1, "cuda"), shape=shape)
    params = init_params(cfg, seed=0, device="cuda")
    inputs = concrete_inputs(cfg, shape, seed=0, device="cuda")
    caches, token, pos = inputs["caches"], inputs["token"], inputs["pos"]
    B = shape.global_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, finite = [], []
    for i in range(I_REPS + 1):     # step 0 warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, caches = step(params, caches, token, pos + i)
        ev[1].record()
        token = logits[:, 0].argmax(-1, keepdim=True)
        finite.append(torch.isfinite(logits).all())
        events.append(ev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _profile(torch, label, lambda: step(params, caches, token,
                                        pos + I_REPS + 1))
    ms = statistics.median(a.elapsed_time(b) for a, b in events[1:])
    bound, bound_by = _decode_bound(cfg, params, caches, B, pos, shape.long,
                                    rate)
    lens = sorted({c.k.shape[2] for c in caches.values()
                   if isinstance(c, KVCache)})
    log(f"  {label} [{card}]: {cfg.n_layers} layers, B {B}, seq_len "
        f"{shape.seq_len}{f', KV cache lengths {lens}' if lens else ''} at "
        f"pos {pos}{' (long_mode)' if shape.long else ''}, caches "
        f"{_cache_bytes(caches)} bytes: {ms:.3f} ms a step (median of "
        f"{I_REPS}, CUDA events), {B / ms * 1e3:.1f} tokens/s; bound "
        f"{bound:.3f} ms ({bound_by}), {bound / ms:.3f} of it; peak device "
        f"memory {peak / 2**30:.2f} GiB")
    if not all(bool(f) for f in finite):
        raise AssertionError(f"{label}: non-finite logits")


def phase_i3(torch):
    """The card against the CPU on the reduced chatglm3 and gemma3
    (local:global, window 64), float32 and bf16 compute: the same numpy
    prompt of 60 tokens, then 16 greedy steps (positions 60-75, past the
    local layers' window).  float32 logits agree to rtol/atol 1e-4; the
    greedy tokens are equal wherever the CPU's top-2 margin exceeds the
    dtype's; a sequence's first disagreement ends its comparison."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import init_params

    for arch in ("chatglm3-6b", "gemma3-12b"):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_arch(arch).reduced(),
                                      compute_dtype=dtype)
            label = f"I3 {cfg.name} {dtype}"
            prompt = np.random.default_rng(3).integers(
                0, cfg.vocab_size, (I3_BATCH, I3_PROMPT)).astype(np.int32)
            params = init_params(cfg, seed=0, device="cpu")
            runs = [_greedy_run(torch, params_from_numpy(params, dev), prompt,
                                cfg, dev) for dev in ("cpu", "cuda")]
            agreed, worst = _greedy_compare(label, *runs, I3_MARGIN[dtype],
                                            logits_gate=dtype == "float32")
            log(f"  {label}: {agreed} of {I3_BATCH * (I3_STEPS + 1)} greedy "
                f"tokens equal before the sequences' first disagreements; "
                f"logits max |card - CPU| {worst:.3e} over them")


def _greedy_run(torch, params, prompt, cfg, dev, frontend_embeds=None,
                tp=None):
    """Prefill ``prompt`` (numpy; a modality family's ``frontend_embeds``,
    numpy, in its first positions) on ``dev``, then ``I3_STEPS`` greedy
    decode steps: the last-position logits of each, on the host."""
    from repro_torch.models import decode_step, prefill

    fe = None if frontend_embeds is None else \
        torch.from_numpy(frontend_embeds).to(dev)
    logits, caches, _ = prefill(params, torch.from_numpy(prompt).to(dev),
                                cfg, max_len=prompt.shape[1] + I3_STEPS,
                                frontend_embeds=fe, tp=tp)
    seq = [logits[:, -1].cpu()]
    for t in range(I3_STEPS):
        tok = seq[-1].argmax(-1, keepdim=True).to(torch.int32)
        logits, caches = decode_step(params, caches, tok.to(dev),
                                     prompt.shape[1] + t, cfg, tp=tp)
        seq.append(logits[:, 0].cpu())
    return seq


def _greedy_compare(label, cpu_seq, card_seq, gate, *, logits_gate):
    """The card's greedy run against the CPU's, step by step (each a list
    of ``(B, V)`` logits): float32 logits to rtol/atol 1e-4 where
    ``logits_gate``; tokens equal wherever the CPU's top-2 margin exceeds
    ``gate``.  A sequence's comparison ends at its first disagreement: from
    there the two runs feed different tokens.  Returns (tokens agreed, max
    |card - CPU| over the compared logits)."""
    import torch

    live = torch.ones(cpu_seq[0].shape[0], dtype=torch.bool)
    worst, agreed = 0.0, 0
    for t, (cpu, card) in enumerate(zip(cpu_seq, card_seq)):
        if logits_gate:
            np.testing.assert_allclose(
                card[live].numpy(), cpu[live].numpy(), rtol=1e-4,
                atol=1e-4, err_msg=f"{label}, step {t}")
        worst = max(worst, float((card - cpu)[live].abs().max()))
        top2 = cpu.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        differ = live & (cpu.argmax(-1) != card.argmax(-1))
        for b in differ.nonzero()[:, 0].tolist():
            m = float(margin[b])
            log(f"  {label}: sequence {b}'s first disagreement at step {t}, "
                f"CPU top-2 margin {m:.3e} (gate {gate})")
            if m > gate:
                raise AssertionError(f"{label}: sequence {b}'s tokens differ "
                                     f"at step {t}, margin {m:.3e}")
        live &= ~differ
        agreed += int(live.sum())
        if not bool(live.any()):
            break
    return agreed, worst


def phase_i4():
    """``python -m repro_torch.launch.serve --role decode`` with its
    defaults, on the card: ``--batch`` rows of ``--gen`` ids, each in
    [0, vocab)."""
    out = _run_launcher("I4", "repro_torch.launch.serve", ["--role", "decode"],
                        _child_env())
    _check_decode_rows("I4", out, "chatglm3-6b")


def _check_decode_rows(label, out, arch):
    """The decode launcher's defaults on the card: 4 rows of 16 ids, each
    in [0, vocab) of ``arch``'s reduced variant."""
    import re

    from repro_torch.configs import get_arch

    vocab = get_arch(arch).reduced().vocab_size
    rows = [json.loads(m.group(2))
            for m in re.finditer(r"^  seq (\d+) (\[.*\])$", out, re.M)]
    if len(rows) != 4 or any(len(r) != 16 for r in rows) \
            or any(not 0 <= x < vocab for r in rows for x in r):
        raise AssertionError(f"{label}: expected 4 rows of 16 ids in [0, "
                             f"{vocab}), got {rows}")
    if "device=cuda" not in out:
        raise AssertionError(f"{label}: the launcher did not run on the card")
    log(f"  {label}: 4 rows of 16 ids in [0, {vocab}) on the card")


# ---------------------------------------------------------------------------
# phase J: the MoE family through forward, loss, prefill and decode
# ---------------------------------------------------------------------------

J_ARCH = "qwen3-moe-235b-a22b"
J_LAYERS = 2                      # of qwen3-moe's 94 (J1, J2)
# J2's cells: (arch, input shape, layers, batch cut)
J2_CELLS = (("qwen3-moe-235b-a22b", "decode_32k", 2, None),
            ("qwen3-moe-235b-a22b", "long_500k", 2, None),
            ("dbrx-132b", "decode_32k", 1, None))
# J3's cells: (arch, dispatch, experts of the reduced config); the reduced
# configs route every token to all 4 experts, so the last cell takes 8
# (dbrx's top-4 of 8) and drops pairs
J3_CELLS = (("qwen3-moe-235b-a22b", "dense", 4),
            ("qwen3-moe-235b-a22b", "capacity", 4),
            ("dbrx-132b", "dense", 4),
            ("dbrx-132b", "capacity", 4),
            ("dbrx-132b", "capacity", 8))
J_MARGIN = 1e-6        # router ids are held where the margin exceeds it
J_ROWS = H_ROWS + ("fma",)        # rows 1-4b: the MoE train step's


@contextlib.contextmanager
def _tap(module, name, record):
    """While active, ``module.name`` calls the original and hands
    ``record`` its arguments and result (the callers look it up in the
    module at every call)."""
    orig = getattr(module, name)

    def tapped(*args):
        out = orig(*args)
        record(args, out)
        return out

    setattr(module, name, tapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _routing(torch, calls):
    """Taps ``models.moe.dispatch`` (the capacity path's routing): per
    call its C, pairs, dropped pairs and experts with a kept pair, the
    last two device tensors until read (no host sync inside the work)."""
    from repro_torch.models import moe

    def record(args, out):
        ids, cfg = args
        _, e_s, _, keep, _ = out
        hits = torch.zeros(cfg.moe.n_experts, device=ids.device)
        hits.index_add_(0, e_s, keep.to(torch.float32))
        calls.append((moe.capacity(ids.shape[0], cfg), keep.numel(),
                      (~keep).sum(), (hits > 0).sum()))

    return _tap(moe, "dispatch", record)


def _routing_totals(calls):
    """(each call's C, pairs, dropped pairs, experts with a kept pair),
    the counts summed over the calls (the layers)."""
    return ([c for c, *_ in calls], sum(n for _, n, _, _ in calls),
            sum(int(d) for _, _, d, _ in calls),
            sum(int(u) for *_, u in calls))


def _routing_line(calls) -> str:
    caps, pairs, dropped, used = _routing_totals(calls)
    return (f"C {caps}, {dropped} of {pairs} (token, choice) pairs dropped "
            f"({dropped / pairs:.4f}), {used} experts used over the layers")


def phase_j(torch, results, card, rate):
    """The MoE family: J1 qwen3-moe-235b-a22b at its published widths (2 of
    94 layers), prefill and 64 greedy tokens; J2 decode steps at the
    assigned decode shapes; J3 the card against the CPU on the reduced
    MoE models (forward, loss with aux, router ids, greedy decode) and one
    MoE train step (rows 1-4b); J4 the decode and train launchers.  No
    kernel of the port lies on the MoE forward path: the counters are
    read over J1-J3's model runs and printed."""
    import re

    from repro_torch import kernels

    kernels.reset_launches()
    phase_j1(torch, card, rate)
    torch.cuda.empty_cache()
    phase_j2(torch, card, rate)
    torch.cuda.empty_cache()
    phase_j3(torch)
    torch.cuda.empty_cache()
    log(f"  J1-J3: kernel launches "
        f"{ {k.name: k.launches for k in kernels.KERNELS} } (no kernel on "
        f"the MoE forward and decode path)")
    phase_j3_train(torch, results)
    torch.cuda.empty_cache()
    out = _run_launcher("J4 serve", "repro_torch.launch.serve",
                        ["--role", "decode", "--arch", J_ARCH], _child_env())
    _check_decode_rows("J4 serve", out, J_ARCH)
    out = _run_launcher("J4 train", "repro_torch.launch.train",
                        ["--arch", "dbrx-132b", "--steps", "3"], _child_env())
    losses = [float(x) for x in re.findall(r"step +\d+ loss=(\S+)", out)]
    if len(losses) != 3 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"J4 train: losses {losses}")


def phase_j1(torch, card, rate):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_arch(J_ARCH), n_layers=J_LAYERS)
    e = cfg.moe
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"  J1: {cfg.name} at its published widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, "
        f"{e.n_experts} experts of d_expert {e.d_expert}, top-{e.top_k}, "
        f"capacity factor {e.capacity_factor}, {e.impl} dispatch, vocab "
        f"{cfg.vocab_size}), {cfg.n_layers} layers: {n_params} parameters "
        f"({4 * n_params} bytes); B {I_BATCH}, a prompt of {I_PROMPT}, "
        f"{I_GEN} greedy tokens")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (I_BATCH, I_PROMPT)).astype(np.int32)).cuda()
    max_len = I_PROMPT + I_GEN
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, routing = [], []
    for i in range(2):      # the first call warms up and counts the routing
        logits = caches = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with _routing(torch, routing) if i == 0 else \
                contextlib.nullcontext():
            logits, caches, aux = prefill(params, prompt, cfg,
                                          max_len=max_len)
        ev[1].record()
        torch.cuda.synchronize()
        prefill_ms.append(ev[0].elapsed_time(ev[1]))
    tokens = [logits[:, -1].argmax(-1)]
    finite = [torch.isfinite(logits).all()]
    events = []
    for t in range(I_GEN - 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, caches = decode_step(params, caches, tokens[-1][:, None],
                                     I_PROMPT + t, cfg)
        ev[1].record()
        events.append(ev)
        tokens.append(logits[:, 0].argmax(-1))
        finite.append(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # one more step at the last position (which it writes again) under the
    # profiler, and one counting its routing
    _profile(torch, "J1 decode", lambda: decode_step(
        params, caches, tokens[-1][:, None], max_len - 1, cfg))
    step_routing = []
    with _routing(torch, step_routing):
        decode_step(params, caches, tokens[-1][:, None], max_len - 1, cfg)
    _, pairs, dropped, used = _routing_totals(step_routing)
    bound, bound_by = _decode_bound(cfg, params, caches, I_BATCH,
                                    max_len - 1, False, rate,
                                    moe=(used, pairs - dropped))
    step_ms = [a.elapsed_time(b) for a, b in events]
    step = statistics.median(step_ms)
    out = torch.stack(tokens, dim=1).cpu()
    want = 2 * cfg.n_layers * I_BATCH * max_len * cfg.n_kv_heads * cfg.hd * 2
    log(f"  J1 [{card}]: prefill {prefill_ms[1]:.3f} ms (first call "
        f"{prefill_ms[0]:.3f}); decode {step:.3f} ms a step (median of steps "
        f"1-{I_GEN - 1}, CUDA events; range {min(step_ms):.3f}-"
        f"{max(step_ms):.3f}), {I_BATCH / step * 1e3:.1f} tokens/s; bound "
        f"{bound:.3f} ms ({bound_by}), {bound / step:.3f} of it; peak device "
        f"memory {peak / 2**30:.2f} GiB; caches {_cache_bytes(caches)} bytes")
    log(f"  J1 prefill routing: {_routing_line(routing)}; aux load_balance "
        f"{float(aux['load_balance']):.6f}, router_z "
        f"{float(aux['router_z']):.6f}")
    log(f"  J1 decode step routing: {_routing_line(step_routing)}")
    log(f"  J1: sequence 0's first tokens {out[0, :12].tolist()}")
    if not all(bool(f) for f in finite):
        raise AssertionError("J1: non-finite logits")
    if out.shape != (I_BATCH, I_GEN) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"J1: tokens out of range, shape {out.shape}")
    if _cache_bytes(caches) != want:
        raise AssertionError(f"J1: caches hold {_cache_bytes(caches)} bytes, "
                             f"not {want}")
    want_c = round(I_BATCH * I_PROMPT * e.top_k / e.n_experts
                   * e.capacity_factor)
    if _routing_totals(routing)[0] != [want_c] * cfg.n_layers:
        raise AssertionError(f"J1: prefill capacity "
                             f"{_routing_totals(routing)[0]}, not {want_c} "
                             f"a layer")
    for key, val in aux.items():
        if not bool(torch.isfinite(val)) or float(val) <= 0:
            raise AssertionError(f"J1: prefill aux {key} = {float(val)}")


def phase_j2(torch, card, rate):
    import dataclasses

    from repro_torch.configs import concrete_inputs, get_arch, get_shape
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import init_params

    for arch, shape_name, layers, batch in J2_CELLS:
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        shape = get_shape(shape_name)
        if batch is not None:
            shape = dataclasses.replace(shape, global_batch=batch)
        label = f"J2 {arch} {shape_name}"
        step = build_serve_step(cfg, LaneMesh(1, "cuda"), shape=shape)
        params = init_params(cfg, seed=0, device="cuda")
        inputs = concrete_inputs(cfg, shape, seed=0, device="cuda")
        caches, token, pos = inputs["caches"], inputs["token"], inputs["pos"]
        B = shape.global_batch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events, finite, routing = [], [], []
        for i in range(I_REPS + 1):     # step 0 warms up, routing counted
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            with _routing(torch, routing) if i == 0 else \
                    contextlib.nullcontext():
                logits, caches = step(params, caches, token, pos + i)
            ev[1].record()
            token = logits[:, 0].argmax(-1, keepdim=True)
            finite.append(torch.isfinite(logits).all())
            events.append(ev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        _profile(torch, label, lambda: step(params, caches, token,
                                            pos + I_REPS + 1))
        ms = statistics.median(a.elapsed_time(b) for a, b in events[1:])
        _, pairs, dropped, used = _routing_totals(routing)
        bound, bound_by = _decode_bound(cfg, params, caches, B, pos,
                                        shape.long, rate,
                                        moe=(used, pairs - dropped))
        lens = sorted({c.k.shape[2] for c in caches.values()})
        log(f"  {label} [{card}]: {cfg.n_layers} layers, B {B}, cache "
            f"lengths {lens} at pos {pos}"
            f"{' (long_mode)' if shape.long else ''}, caches "
            f"{_cache_bytes(caches)} bytes: {ms:.3f} ms a step (median of "
            f"{I_REPS}, CUDA events), {B / ms * 1e3:.1f} tokens/s; bound "
            f"{bound:.3f} ms ({bound_by}, step 0's routing), "
            f"{bound / ms:.3f} of it; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"  {label} step 0 routing: {_routing_line(routing)}")
        if not all(bool(f) for f in finite):
            raise AssertionError(f"{label}: non-finite logits")
        del params, inputs, caches, logits, step
        torch.cuda.empty_cache()


def _router_log(torch, calls):
    """Taps ``models.moe.router_probs``: per call the ids and each token's
    margin on the host, the least gap between neighbours among its k + 1
    largest router probabilities (its k largest when k is every expert),
    the gap a rounding must close to change its ids or their order."""
    from repro_torch.models import moe

    def record(args, out):
        p, x, cfg = args
        probs = torch.softmax(x.float() @ p["router"]["w"].float(), -1)
        top = torch.sort(probs, dim=-1,
                         descending=True).values[:, :cfg.moe.top_k + 1]
        calls.append((out[1].cpu(),
                      (top[:, :-1] - top[:, 1:]).min(-1).values.cpu()))

    return _tap(moe, "router_probs", record)


def phase_j3(torch):
    """The card against the CPU on the reduced MoE models (J3_CELLS),
    float32 and bf16 compute, from the same weights and numpy prompt (4 x
    60): float32 forward logits to rtol/atol 1e-4 (I3's gate), the loss
    with its aux and the aux themselves to rtol 1e-4 (H2's), the router's
    ids equal at every layer and token whose CPU margin exceeds 1e-6 (the
    rest excused, at most 1 in 1,000 tokens); then prefill and 16 greedy
    steps under I3's token gates."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import forward, init_params, loss_fn

    excused = low = tokens = 0
    for arch, impl, experts in J3_CELLS:
        base = get_arch(arch).reduced(n_experts=experts)
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(
                base, compute_dtype=dtype,
                moe=dataclasses.replace(base.moe, impl=impl))
            label = f"J3 {cfg.name} {impl} E{experts} {dtype}"
            prompt = np.random.default_rng(3).integers(
                0, cfg.vocab_size, (I3_BATCH, I3_PROMPT)).astype(np.int32)
            params = init_params(cfg, seed=0, device="cpu")
            runs = {}
            for dev in ("cpu", "cuda"):
                p = params_from_numpy(params, dev)
                tok = torch.from_numpy(prompt).to(dev)
                router = []
                with torch.no_grad(), _router_log(torch, router):
                    logits = forward(p, tok, cfg).cpu()
                    loss, metrics = loss_fn(p, {"tokens": tok}, cfg)
                runs[dev] = dict(
                    logits=logits, loss=float(loss),
                    metrics={k: float(v) for k, v in metrics.items()},
                    router=router[:cfg.n_layers],
                    seq=_greedy_run(torch, p, prompt, cfg, dev))
            cpu, card = runs["cpu"], runs["cuda"]
            if dtype == "float32":
                np.testing.assert_allclose(card["logits"].numpy(),
                                           cpu["logits"].numpy(), rtol=1e-4,
                                           atol=1e-4, err_msg=label)
                np.testing.assert_allclose(card["loss"], cpu["loss"],
                                           rtol=1e-4, err_msg=label)
                for key in cpu["metrics"]:
                    np.testing.assert_allclose(
                        card["metrics"][key], cpu["metrics"][key], rtol=1e-4,
                        err_msg=f"{label} {key}")
                for (ids_c, margin), (ids_g, _) in zip(cpu["router"],
                                                       card["router"]):
                    differ = (ids_c != ids_g).any(-1)
                    small = margin <= J_MARGIN
                    if bool((differ & ~small).any()):
                        raise AssertionError(
                            f"{label}: router ids differ at tokens "
                            f"{(differ & ~small).nonzero()[:, 0].tolist()}, "
                            f"margins above {J_MARGIN}")
                    excused += int((differ & small).sum())
                    low += int(small.sum())
                    tokens += ids_c.shape[0]
            agreed, worst = _greedy_compare(label, cpu["seq"], card["seq"],
                                            I3_MARGIN[dtype],
                                            logits_gate=dtype == "float32")
            log(f"  {label}: loss card {card['loss']:.6f} CPU "
                f"{cpu['loss']:.6f}, load_balance "
                f"{card['metrics']['load_balance']:.6f} / "
                f"{cpu['metrics']['load_balance']:.6f}, router_z "
                f"{card['metrics']['router_z']:.6f} / "
                f"{cpu['metrics']['router_z']:.6f}; {agreed} of "
                f"{I3_BATCH * (I3_STEPS + 1)} greedy tokens equal before the "
                f"first disagreements (logits max |card - CPU| {worst:.3e})")
    log(f"  J3: router ids equal at every float32 layer and token but "
        f"{excused} excused of {tokens} ({low} under the {J_MARGIN} margin)")
    if excused * 1000 > tokens:
        raise AssertionError(f"J3: {excused} router ids excused of {tokens}")


def phase_j3_train(torch, results):
    """One MoE train step, the reduced qwen3-moe (capacity dispatch,
    float32), under ``_train_gates``."""
    import dataclasses

    from repro_torch.configs import get_arch

    base = get_arch(J_ARCH).reduced()
    cfg = dataclasses.replace(base, compute_dtype="float32",
                              moe=dataclasses.replace(base.moe,
                                                      impl="capacity"))
    launches = _train_gates(torch, cfg, "J3 train")
    for row in results:
        row["launches_j3"] = launches[row["name"]]


def _train_gates(torch, cfg, label, model: int = 1):
    """One train step of ``cfg`` (a reduced model, float32) on 4 lanes
    (W = 4 data workers, or 4 / ``model`` each of ``model`` shards, at
    least one), batch
    16 x 128 (and a modality family's frontend embeddings),
    the card against the CPU from the same numpy weights and batch.  The
    blockwise allgather step end to end on the card launches rows 1-4b
    (counted over that step alone) and gives the CPU's loss to rtol 1e-4;
    the blockwise exchange on the card fed the CPU's gradients gives the
    CPU's parameters and velocities bit for bit (H2b's gate); the exact
    engine's step holds H2a's (parameters atol 1e-5 but at support swaps,
    at most 1 in 10,000), where a swap is a coordinate that some lane
    selects on one side only: its difference is that lane's share of the
    mean (to 1e-3, relative) and it lies within ``H_TIE`` of its row's
    boundary on that lane.  Returns the step's launches by kernel name."""
    from repro_torch import kernels
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.core.paramspace import tree_flatten, tree_unflatten
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params

    W = max(1, H_W // model)
    leaves, paths = tree_flatten(init_params(cfg, seed=0, device="cpu"))
    leaves_np = [x.numpy() for x in leaves]
    tokens = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                         batch_size=H_BATCH, seed=0,
                         device="cpu").batch(0)["tokens"].numpy()
    fe = None
    if cfg.frontend_tokens:
        fe = np.random.default_rng(1).standard_normal(
            (H_BATCH, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)

    def flat(tree):
        return [x.cpu().numpy().copy() for x in tree_flatten(tree)[0]]

    def setup(engine, dev):
        ex_cfg = ExchangeConfig(mode="allgather", density=H_DENSITY,
                                momentum=H_MOMENTUM, engine=engine)
        step = build_train_step(cfg, LaneMesh(W, dev, model=model),
                                ex_cfg, lr=H_LR, remat=False)
        params = _h2_params(torch, paths, leaves_np, dev)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if fe is not None:
            batch["frontend_embeds"] = torch.from_numpy(fe).to(dev)
        return step, params, step.init_state(params), batch

    # the blockwise step end to end; the card's launches counted over it
    step, params, state, batch = setup("blockwise", "cpu")
    grads, lane_losses = step.grads(params, batch)
    updates, state = step.exchange(state, grads)
    step.apply(params, updates)
    cpu_loss, cpu_params, cpu_vel = (float(step.mesh.mean(lane_losses)),
                                     flat(params), flat(state.velocity))
    g_leaves, g_paths = tree_flatten(grads)
    step, params, state, batch = setup("blockwise", "cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    params, state, loss = step(params, state, batch)
    torch.cuda.synchronize()
    launches = {info.name: info.launches for info in kernels.KERNELS}
    log(f"  {label}: the blockwise allgather step on the card launched "
        f"{launches}; loss card {float(loss):.6f}, CPU {cpu_loss:.6f}")
    idle = [k for k in J_ROWS if launches[k] == 0]
    if idle:
        raise AssertionError(f"{label}: rows {idle} never launched")
    np.testing.assert_allclose(float(loss), cpu_loss, rtol=1e-4)

    # H2b: the card's blockwise exchange fed the CPU's gradients
    step, params, state, _ = setup("blockwise", "cuda")
    updates, state = step.exchange(state, tree_unflatten(
        g_paths, [x.cuda() for x in g_leaves]))
    step.apply(params, updates)
    for what, a, c in (("parameters", flat(params), cpu_params),
                        ("velocities", flat(state.velocity), cpu_vel)):
        bad = ["/".join(p) for p, x, y in zip(paths, a, c)
               if not np.array_equal(x.view(np.int32), y.view(np.int32))]
        if bad:
            raise AssertionError(f"{label}: {what} differ: {bad}")
    del grads, g_leaves

    # H2a: the exact engine's step end to end, support swaps counted.  In
    # one step a swap on one lane moves a coordinate by that lane's share
    # of the mean, |m * u + lr * g| / W, whether or not another lane
    # selects it too
    after, lanes = {}, None
    for dev in ("cpu", "cuda"):
        step, params, state, batch = setup("exact", dev)
        if dev == "cpu":
            lanes = _tie_gaps(torch, step, state.velocity,
                              step.grads(params, batch)[0], lanes=True)
        params, state, _ = step(params, state, batch)
        after[dev] = flat(params)
    excused = total = 0
    worst = 0.0
    for j, path in enumerate(paths):
        diff = np.abs(after["cuda"][j] - after["cpu"][j])
        bad = diff > 1e-5
        gap = lanes[j][0][:, bad]
        acc = lanes[j][1][:, bad] / W
        share = np.abs(diff[bad] - acc) <= 1e-3 * acc + 1e-6
        ok = ((gap <= H_TIE) & share).any(0)
        if not ok.all():
            raise AssertionError(
                f"{label}: {'/'.join(path)}: {int((~ok).sum())} of "
                f"{int(bad.sum())} parameters outside atol 1e-5 are no "
                f"lane's swap at its row's boundary: |diff| "
                f"{diff[bad][~ok].tolist()[:4]}, lane shares "
                f"{acc[:, ~ok].T.tolist()[:4]}, distances "
                f"{gap[:, ~ok].T.tolist()[:4]}")
        excused += int(bad.sum())
        total += diff.size
        worst = max(worst, float(diff[~bad].max(initial=0.0)))
    log(f"  {label}: the blockwise exchange on the card fed the CPU's "
        f"gradients: parameters and velocities bit-equal; the exact step: "
        f"parameters max |diff| {worst:.3g} but at {excused} support swaps of "
        f"{total} (each one lane's share of the mean, within {H_TIE} of its "
        f"row's boundary on that lane)")
    if excused > total // 10_000:
        raise AssertionError(f"{label}: {excused} support swaps")
    return launches


# ---------------------------------------------------------------------------
# phase K: MLA (minicpm3-4b), the Mamba2/SSD block (mamba2-780m) and the
# hybrid with shared attention (zamba2-2.7b)
# ---------------------------------------------------------------------------

# (arch, layers of the published depth, None = all): minicpm3 2 of 62;
# mamba2 all 48; zamba2 one unit of its pattern (5 mamba, 1 mamba_attn)
K_FAMILIES = (("minicpm3-4b", 2), ("mamba2-780m", None),
              ("zamba2-2.7b", 6))
# K2's cells: (arch, input shape, layers, batch cut, MLA absorb); minicpm3
# without absorption expands k_nope and v for the whole cache (B 16 of
# 128), zamba2's shared K/V hold 42.9 GB a layer at B 128 (B 32)
K2_CELLS = (("minicpm3-4b", "decode_32k", 2, 16, False),
            ("minicpm3-4b", "decode_32k", 2, None, True),
            ("minicpm3-4b", "long_500k", 2, None, False),
            ("mamba2-780m", "decode_32k", None, None, None),
            ("mamba2-780m", "long_500k", None, None, None),
            ("zamba2-2.7b", "decode_32k", 6, 32, None),
            ("zamba2-2.7b", "long_500k", 6, None, None))
# K3's reduced models: (arch, MLA absorb)
K3_CELLS = (("minicpm3-4b", False), ("minicpm3-4b", True),
            ("mamba2-780m", None), ("zamba2-2.7b", None))


def _k_cfg(arch, layers=None, absorb=None):
    """``arch`` at its published widths, ``layers`` deep (None: all), MLA
    decode absorbed or not (None: the config's)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if absorb is not None:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, absorb=absorb))
    return cfg


def phase_k(torch, results, card, rate):
    """The MLA, Mamba2 and hybrid families: K1 each at its published
    widths, prefill and 64 greedy tokens; K2 decode steps at the assigned
    decode shapes; K3 the card against the CPU on the reduced models and
    ``ssd_chunked`` against the recurrence; K4 one train step of each at
    full width (rows 1-4b), then H2's gates on the reduced models; K5 the
    launchers.  No kernel lies on the forward and decode path: the
    counters are read over K1-K3 and printed."""
    from repro_torch import kernels

    kernels.reset_launches()
    for arch, layers in K_FAMILIES:
        _generate(torch, card, rate, _k_cfg(arch, layers), f"K1 {arch}")
        torch.cuda.empty_cache()
    phase_k2(torch, card, rate)
    torch.cuda.empty_cache()
    phase_k3(torch)
    torch.cuda.empty_cache()
    log(f"  K1-K3: kernel launches "
        f"{ {k.name: k.launches for k in kernels.KERNELS} } (no kernel on "
        f"the forward and decode path)")
    phase_k4(torch, results, card)
    torch.cuda.empty_cache()
    phase_k5()


def phase_k2(torch, card, rate):
    import dataclasses

    from repro_torch.configs import get_shape

    for arch, shape_name, layers, batch, absorb in K2_CELLS:
        shape = get_shape(shape_name)
        if batch is not None:
            shape = dataclasses.replace(shape, global_batch=batch)
        _decode_cell(torch, card, rate, f"K2 {arch} {shape_name}" + (
            "" if absorb is None else f" absorb={absorb}"),
            _k_cfg(arch, layers, absorb), shape)
        torch.cuda.empty_cache()


def _k3_cfg(arch, absorb, dtype):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype=dtype)
    if absorb is not None:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, absorb=absorb))
    return cfg


def phase_k3(torch):
    """The card against the CPU on the reduced MLA (both decode
    branches), Mamba2 and hybrid models, float32 and bf16 compute, from
    the same weights and numpy prompt (4 x 60): float32 forward logits to
    rtol/atol 1e-4 and the loss to rtol 1e-4; then prefill and 16 greedy
    steps under I3's gates.  And ``ssd_chunked`` on the card (B 2, S 256,
    8 heads of 64, 2 groups, state 64, chunks of 64) against the
    sequential recurrence in float64 (atol 1e-4) and against the CPU's
    (rtol/atol 1e-4, I3's)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.models import ssm

    for arch, absorb in K3_CELLS:
        for dtype in ("float32", "bfloat16"):
            cfg = _k3_cfg(arch, absorb, dtype)
            label = f"K3 {cfg.name}" + (
                "" if absorb is None else f" absorb={absorb}") + f" {dtype}"
            prompt = np.random.default_rng(3).integers(
                0, cfg.vocab_size, (I3_BATCH, I3_PROMPT)).astype(np.int32)
            params = init_params(cfg, seed=0, device="cpu")
            runs = {}
            for dev in ("cpu", "cuda"):
                p = params_from_numpy(params, dev)
                tok = torch.from_numpy(prompt).to(dev)
                with torch.no_grad():
                    logits = forward(p, tok, cfg).cpu()
                    loss = float(loss_fn(p, {"tokens": tok}, cfg)[0])
                runs[dev] = dict(logits=logits, loss=loss,
                                 seq=_greedy_run(torch, p, prompt, cfg, dev))
            cpu, card = runs["cpu"], runs["cuda"]
            if dtype == "float32":
                np.testing.assert_allclose(card["logits"].numpy(),
                                           cpu["logits"].numpy(), rtol=1e-4,
                                           atol=1e-4, err_msg=label)
                np.testing.assert_allclose(card["loss"], cpu["loss"],
                                           rtol=1e-4, err_msg=label)
            agreed, worst = _greedy_compare(label, cpu["seq"], card["seq"],
                                            I3_MARGIN[dtype],
                                            logits_gate=dtype == "float32")
            log(f"  {label}: loss card {card['loss']:.6f} CPU "
                f"{cpu['loss']:.6f}; {agreed} of {I3_BATCH * (I3_STEPS + 1)} "
                f"greedy tokens equal before the first disagreements (logits "
                f"max |card - CPU| {worst:.3e})")

    rng = np.random.default_rng(4)
    B, S, H, P, G, N = 2, 256, 8, 64, 2, 64
    x = rng.normal(size=(B, S, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)) - 2.0))
    A = -np.exp(rng.normal(size=H))
    Bm = rng.normal(size=(B, S, G, N)) * 0.3
    Cm = rng.normal(size=(B, S, G, N)) * 0.3
    args = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    cpu_out, card_out = ([t.cpu().numpy() for t in ssm.ssd_chunked(
        *(torch.from_numpy(a).to(dev) for a in args), chunk=64)]
        for dev in ("cpu", "cuda"))
    # the recurrence one step at a time, float64
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in args)
    state = np.zeros((B, H, P, N))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        Bt = np.repeat(Bm[:, t], H // G, axis=1)
        Ct = np.repeat(Cm[:, t], H // G, axis=1)
        state = (state * np.exp(dt[:, t] * A)[..., None, None]
                 + (x[:, t] * dt[:, t][..., None])[..., None]
                 * Bt[:, :, None, :])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ct)
    err = [float(np.abs(card_out[0] - ys).max()),
           float(np.abs(card_out[1] - state).max())]
    log(f"  K3 ssd_chunked on the card: max |y - recurrence| {err[0]:.3e}, "
        f"final state {err[1]:.3e}; max |card - CPU| "
        f"{float(np.abs(card_out[0] - cpu_out[0]).max()):.3e}")
    np.testing.assert_allclose(card_out[0], ys, atol=1e-4,
                               err_msg="K3 ssd_chunked y")
    np.testing.assert_allclose(card_out[1], state, atol=1e-4,
                               err_msg="K3 ssd_chunked state")
    for a, b in zip(card_out, cpu_out):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg="K3 ssd_chunked card vs CPU")


def phase_k4(torch, results, card):
    """One blockwise allgather train step of each family at full width
    (K_FAMILIES) on W = 4 lanes of the card, batch 16 x 128, density 0.05,
    after one step that warms up: rows 1-4b each launched over the steps,
    the split by CUDA events; then ``_train_gates`` on each reduced model
    (float32), the card against the CPU."""
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.models.model import abstract_params

    _k4_tall_rows(torch)
    mesh = LaneMesh(H_W, "cuda")
    counts = {}
    for arch, layers in K_FAMILIES:
        cfg = _k_cfg(arch, layers)
        label = f"K4 {cfg.name}"
        stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                             batch_size=H_BATCH, seed=0, device="cuda")
        n_params = sum(p.numel() for p in tree_leaves(abstract_params(cfg)))
        log(f"  {label}: {cfg.n_layers} layers, {n_params} parameters; W = "
            f"{H_W} lanes, batch {H_BATCH} x seq {H_SEQ}, density "
            f"{H_DENSITY}, blockwise allgather")
        _, _, _, launches, _ = _h_run(torch, label, cfg, mesh,
                                      _h_exchange("allgather"), stream, 2,
                                      card)
        idle = [k for k in J_ROWS if launches[k] == 0]
        if idle:
            raise AssertionError(f"{label}: rows {idle} never launched")
        counts[cfg.name] = launches
        torch.cuda.empty_cache()
    for row in results:
        row["launches_k4"] = {name: c[row["name"]] / 2
                              for name, c in counts.items()}
    for arch, _ in K_FAMILIES:
        _train_gates(torch, _k3_cfg(arch, None, "float32"),
                     f"K4 train {arch}")
        torch.cuda.empty_cache()


def _k4_tall_rows(torch):
    """Kernel 4 and its fused multiply-adds (rows 4, 4a, 4b) on a block
    of more rows than a grid's y dimension holds (65,535): minicpm3's
    embedding and head are cut into 73,448 rows.  Each bit-equal to its
    plain version on the CPU."""
    from repro_torch.kernels import ops, samomentum_kernel as sk

    rng = np.random.default_rng(5)
    rows, n, m, lr = 73_448, 96, H_MOMENTUM, H_LR
    u, g, c = (rng.normal(size=(rows, n)).astype(np.float32)
               for _ in range(3))
    thr = np.abs(rng.normal(size=rows)).astype(np.float32)
    def run(dev):
        tu, tg, tc, tt = (torch.from_numpy(x).to(dev) for x in (u, g, c, thr))
        uacc = sk.velocity_accumulate(tu, tg, momentum=m, lr=lr)
        sent, u_new = ops.samomentum_fused_rows(uacc, uacc, tt, momentum=m,
                                                lr=1.0 - m)
        res = sk.fused_multiply_add(sent, 1.0 / m - 1.0, tc)
        return [x.cpu().numpy() for x in (uacc, sent, u_new, res)]

    for name, a, b in zip(("accumulate", "fused sent", "fused u_new", "fma"),
                          run("cuda"), run("cpu")):
        if not np.array_equal(a.view(np.int32), b.view(np.int32)):
            raise AssertionError(f"K4 {rows} rows: {name} differs from its "
                                 f"plain version")
    log(f"  K4: rows 4, 4a, 4b on ({rows}, {n}) bit-equal to their plain "
        f"versions (grids of 65,535 rows at most a launch)")


def phase_k5():
    """``launch/train.py --arch`` (3 steps) and ``launch/serve.py --role
    decode --arch`` for each family on the card, the six processes at
    once: each exits 0, the trainer's losses are finite and the decoder
    prints 4 rows of 16 ids in range."""
    _launchers("K5", [arch for arch, _ in K_FAMILIES])


def _launchers(phase, archs):
    """The train (3 steps) and decode launchers of each of ``archs`` on
    the card, all at once."""
    import re

    jobs = []
    for arch in archs:
        jobs.append((f"{phase} train {arch}", "repro_torch.launch.train",
                     ["--arch", arch, "--steps", "3"], arch))
        jobs.append((f"{phase} serve {arch}", "repro_torch.launch.serve",
                     ["--role", "decode", "--arch", arch], arch))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", module, *flags],
                              cwd=ROOT, env=_child_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _, module, flags, _ in jobs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=400)[0])
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    log(f"  {phase}: {len(jobs)} launchers at once, "
        f"{time.perf_counter() - t0:.1f} s (process start-up included)")
    for (label, _, _, arch), proc, out in zip(jobs, procs, outs):
        for line in out.strip().splitlines()[-4:]:
            log(f"  {label} | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{label}: exited {proc.returncode}")
        if "train" in label:
            losses = [float(x) for x in re.findall(r"step +\d+ loss=(\S+)",
                                                   out)]
            if len(losses) != 3 or not np.all(np.isfinite(losses)):
                raise AssertionError(f"{label}: losses {losses}")
        else:
            _check_decode_rows(label, out, arch)


# ---------------------------------------------------------------------------
# phase L: M-RoPE and the modality frontends (qwen2-vl-7b, musicgen-large)
# ---------------------------------------------------------------------------

# (arch, layers of the published depth (None = all), prompt length): the
# prompt is the frontend's embeddings (qwen2-vl's 1,024 patches of a 32 x
# 32 grid, musicgen's 512 frames), then tokens
L_FAMILIES = (("qwen2-vl-7b", 2, 1280), ("musicgen-large", None, 1024))
# L2's cells: (arch, input shape, layers, batch cut); musicgen's 32 MHA
# heads of 64 hold 34.4 GB of K/V a layer at B 128 x 32k: 4 layers at B 16
L2_CELLS = (("qwen2-vl-7b", "decode_32k", 2, None),
            ("qwen2-vl-7b", "long_500k", 2, None),
            ("musicgen-large", "decode_32k", 4, 16),
            ("musicgen-large", "long_500k", None, None))
# L4's full-width train steps: (arch, layers, global batch, seq)
L4_CELLS = (("qwen2-vl-7b", 1, 8, 1280), ("musicgen-large", 8, 16, 640))
L4_BYTES_A_PARAM = (46, 53)      # H1's peak per parameter at W = 4 lanes
L4_LIMIT_GIB = 72                # above it the step runs on W = 2 lanes
L_PREDICTION = (
    "L1 qwen2-vl (2 layers, B 16 x 1,280) prefill 60-200 ms, decode 3-8 ms "
    "a step, bound about 1.2 ms; musicgen (48 layers, B 16 x 1,024) prefill "
    "200-600 ms, decode 10-30 ms a step (host-bound, about 1,200 kernels), "
    "bound about 2.9 ms; L2 qwen2-vl decode_32k (B 128, 17.2 GB of cache) "
    "25-45 ms, bound about 6.3 ms; long_500k 3-8 ms; musicgen decode_32k (4 "
    "layers, B 16, 17.2 GB) 20-40 ms, long_500k (48 layers, B 1) 15-40 ms; "
    "L3 within I3's gates; L4 rows 1-4b launched, qwen2-vl 0.5-1.0 s a step "
    "at 45-66 GiB, musicgen 0.2-0.6 s at 15-30 GiB; L5 exit 0; phase L "
    "100-180 s")


def _frontend_embeds(torch, seed, shape):
    """A bf16 draw on the card: numpy standard normals from ``seed``."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)).to("cuda", torch.bfloat16)


class _FrontendStream:
    """``TokenStream`` batches with the frontend's embeddings beside the
    tokens: ``(batch, frontend_tokens, d_model)`` bf16 from a numpy seed
    per step."""

    def __init__(self, torch, cfg, batch_size, seq_len):
        from repro_torch.data.synthetic import TokenStream

        self.torch, self.cfg = torch, cfg
        self.batch_size, self.seq_len = batch_size, seq_len
        self.tokens = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                  batch_size=batch_size, seed=0,
                                  device="cuda")

    def batch(self, i):
        out = self.tokens.batch(i)
        out["frontend_embeds"] = _frontend_embeds(
            self.torch, (7, i), (self.batch_size, self.cfg.frontend_tokens,
                                 self.cfg.d_model))
        return out


def phase_l(torch, results, card, rate):
    """The modality families: L1 each at its published widths, prefill
    with its frontend's embeddings and 64 greedy tokens; L2 decode steps
    at the assigned decode shapes; L3 the card against the CPU on the
    reduced models with their frontends; L4 one train step of each at full
    width (rows 1-4b), then H2's gates on the reduced models; L5 the
    launchers.  No kernel lies on the forward and decode path: the
    counters are read over L1-L3 and printed."""
    from repro_torch import kernels

    log(f"  L prediction (written before the first run): {L_PREDICTION}")
    kernels.reset_launches()
    for arch, layers, prompt_len in L_FAMILIES:
        cfg = _k_cfg(arch, layers)
        fe = _frontend_embeds(torch, 0, (I_BATCH, cfg.frontend_tokens,
                                         cfg.d_model))
        _generate(torch, card, rate, cfg, f"L1 {arch}",
                  prompt_len=prompt_len, frontend_embeds=fe)
        del fe
        torch.cuda.empty_cache()
    phase_l2(torch, card, rate)
    torch.cuda.empty_cache()
    phase_l3(torch)
    torch.cuda.empty_cache()
    log(f"  L1-L3: kernel launches "
        f"{ {k.name: k.launches for k in kernels.KERNELS} } (no kernel on "
        f"the forward and decode path)")
    phase_l4(torch, results, card)
    torch.cuda.empty_cache()
    phase_l5()


def phase_l2(torch, card, rate):
    import dataclasses

    from repro_torch.configs import get_shape

    for arch, shape_name, layers, batch in L2_CELLS:
        shape = get_shape(shape_name)
        cfg = _k_cfg(arch, layers)
        cuts = [f"{cfg.n_layers} of {_k_cfg(arch).n_layers} layers"]
        if batch is not None:
            cuts.append(f"B {batch} of {shape.global_batch}")
            shape = dataclasses.replace(shape, global_batch=batch)
        log(f"  L2 {arch} {shape_name}: cut to {', '.join(cuts)}")
        _decode_cell(torch, card, rate, f"L2 {arch} {shape_name}", cfg,
                     shape)
        torch.cuda.empty_cache()


def phase_l3(torch):
    """The card against the CPU on the reduced qwen2-vl (M-RoPE, 16 patch
    positions) and musicgen (16 frames), float32 and bf16 compute, from
    the same weights, numpy prompt (4 x 60) and frontend embeddings:
    float32 forward logits to rtol/atol 1e-4 and the loss to rtol 1e-4;
    then prefill and 16 greedy steps under I3's gates."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import forward, init_params, loss_fn

    for arch, _, _ in L_FAMILIES:
        for dtype in ("float32", "bfloat16"):
            cfg = _k3_cfg(arch, None, dtype)
            label = f"L3 {cfg.name} {dtype}"
            prompt = np.random.default_rng(3).integers(
                0, cfg.vocab_size, (I3_BATCH, I3_PROMPT)).astype(np.int32)
            fe = np.random.default_rng(4).standard_normal(
                (I3_BATCH, cfg.frontend_tokens, cfg.d_model),
                dtype=np.float32)
            params = init_params(cfg, seed=0, device="cpu")
            runs = {}
            for dev in ("cpu", "cuda"):
                p = params_from_numpy(params, dev)
                batch = {"tokens": torch.from_numpy(prompt).to(dev),
                         "frontend_embeds": torch.from_numpy(fe).to(dev)}
                with torch.no_grad():
                    logits = forward(p, batch["tokens"], cfg,
                                     frontend_embeds=batch[
                                         "frontend_embeds"]).cpu()
                    loss = float(loss_fn(p, batch, cfg)[0])
                runs[dev] = dict(logits=logits, loss=loss,
                                 seq=_greedy_run(torch, p, prompt, cfg, dev,
                                                 frontend_embeds=fe))
            cpu, card = runs["cpu"], runs["cuda"]
            if dtype == "float32":
                np.testing.assert_allclose(card["logits"].numpy(),
                                           cpu["logits"].numpy(), rtol=1e-4,
                                           atol=1e-4, err_msg=label)
                np.testing.assert_allclose(card["loss"], cpu["loss"],
                                           rtol=1e-4, err_msg=label)
            agreed, worst = _greedy_compare(label, cpu["seq"], card["seq"],
                                            I3_MARGIN[dtype],
                                            logits_gate=dtype == "float32")
            log(f"  {label}: loss card {card['loss']:.6f} CPU "
                f"{cpu['loss']:.6f}; {agreed} of {I3_BATCH * (I3_STEPS + 1)} "
                f"greedy tokens equal before the first disagreements (logits "
                f"max |card - CPU| {worst:.3e})")


def phase_l4(torch, results, card):
    """One blockwise allgather train step of each family at full width
    (L4_CELLS) on W = 4 lanes of the card (2 where the reckoning of H1's
    bytes a parameter passes ``L4_LIMIT_GIB``), density 0.05, its frontend
    embeddings in every batch, after one step that warms up: rows 1-4b
    each launched over the steps, the split by CUDA events; then
    ``_train_gates`` on each reduced model (float32), the card against the
    CPU."""
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.models.model import abstract_params

    counts = {}
    for arch, layers, batch, seq in L4_CELLS:
        cfg = _k_cfg(arch, layers)
        label = f"L4 {cfg.name}"
        n_params = sum(p.numel() for p in tree_leaves(abstract_params(cfg)))
        lo, hi = (n_params * b / 2**30 for b in L4_BYTES_A_PARAM)
        W = H_W if hi <= L4_LIMIT_GIB else 2
        log(f"  {label}: {cfg.n_layers} of {_k_cfg(arch).n_layers} layers, "
            f"{n_params} parameters; reckoned peak {lo:.1f}-{hi:.1f} GiB at "
            f"H1's {L4_BYTES_A_PARAM[0]}-{L4_BYTES_A_PARAM[1]} bytes a "
            f"parameter (limit {L4_LIMIT_GIB}): W = {W} lanes"
            + ("" if W == H_W else " (cut from 4 for memory)")
            + f", global batch {batch} x seq {seq} ({cfg.frontend_tokens} "
            f"frontend embeddings a sequence), density {H_DENSITY}, "
            f"blockwise allgather")
        _, _, _, launches, _ = _h_run(torch, label, cfg, LaneMesh(W, "cuda"),
                                      _h_exchange("allgather"),
                                      _FrontendStream(torch, cfg, batch, seq),
                                      2, card)
        idle = [k for k in J_ROWS if launches[k] == 0]
        if idle:
            raise AssertionError(f"{label}: rows {idle} never launched")
        counts[cfg.name] = launches
        torch.cuda.empty_cache()
    for row in results:
        row["launches_l4"] = {name: c[row["name"]] / 2
                              for name, c in counts.items()}
    for arch, _, _, _ in L4_CELLS:
        _train_gates(torch, _k3_cfg(arch, None, "float32"),
                     f"L4 train {arch}")
        torch.cuda.empty_cache()


def phase_l5():
    """``launch/train.py --arch`` (3 steps) and ``launch/serve.py --role
    decode --arch`` for each modality family on the card, the four
    processes at once: each exits 0, the trainer's losses are finite and
    the decoder prints 4 rows of 16 ids in range."""
    _launchers("L5", [arch for arch, _, _ in L_FAMILIES])


# ---------------------------------------------------------------------------
# phase M: the "model" mesh axis (tensor and expert parallelism)
# ---------------------------------------------------------------------------

M_STEPS = 3
# how near a support swap lies to its row's boundary at full width: a
# float32 row-parallel GEMM's split sum over 6,848 + 6,848 terms rounds
# apart from the whole one by up to about 1e-5 of the gradient (H_TIE is
# the reduced models'; swaps measured up to 1.37e-5 away on an H100)
M_TIE = 1e-4
M_PREDICTION = (
    "M1 chatglm3-6b (2 layers, 940,602,368 parameters) on LaneMesh(2, "
    "model=2): gradients 1.1-1.6x model size 1's (each row-parallel GEMM "
    "split in two and summed, the shards' pieces copied once a step), the "
    "exchange and update unchanged (the lanes keep whole leaves), peak "
    "+4-8 GiB (the pieces' copies); float32 model 2 against model 1 "
    "within H2a's gates, 0-20 support swaps; M2 four gloo ranks bit-equal "
    "to the lanes, each resident within 1% of its reckoned shard bytes; M3 "
    "decode 1.1-1.5x model size 1's ms a step (twice the launches of the "
    "sharded blocks), prefill 1.0-1.3x; card against CPU within I3's "
    "gates; M4 exit 0; phase M 60-140 s")


def phase_m(torch, results, card, ref):
    """The model axis: M1 chatglm3-6b at full width on LaneMesh(2,
    model=2) against model size 1; M2 four gloo ranks on the card against
    the lanes (their resident bytes left in ``ref`` for phase N3); M3
    prefill and decode at model size 2; M4 the launchers."""
    log(f"  M prediction: {M_PREDICTION}")
    phase_m1(torch, results, card)
    torch.cuda.empty_cache()
    phase_m1b(torch)
    torch.cuda.empty_cache()
    phase_m2(torch, ref)
    torch.cuda.empty_cache()
    phase_m3(torch, card)
    torch.cuda.empty_cache()
    phase_m4()


def phase_m1(torch, results, card):
    """chatglm3-6b at its published widths (2 of 28 layers), batch 16 x
    128, the blockwise allgather step: M_STEPS timed steps on LaneMesh(2,
    model=2) and on LaneMesh(2, model=1) (bf16 compute; the split and the
    launches a step of each; rows 1-4b must launch at model size 2), then
    with float32 compute each of M_STEPS steps from model size 1's state
    on both meshes under H2a's gates: losses rtol 1e-4, parameters atol
    1e-5 but at support swaps (a lane's share of the mean, within M_TIE of
    its row's boundary at model size 1), velocities the same but at the
    swap's ``a (1/m - 1)``, at most 1 in 10,000.  At full width a swap
    may lie up to M_TIE from the boundary: a row-parallel GEMM's two
    halves, summed, round apart from the whole GEMM (the largest swap's
    distance is printed)."""
    import dataclasses

    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import LaneMesh

    cfg = _h_cfg(H_LAYERS)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                         batch_size=H_BATCH, seed=0, device="cuda")
    for model in (2, 1):
        label = f"M1 model={model}"
        params, state, _, launches, _ = _h_run(
            torch, label, cfg, LaneMesh(2, "cuda", model=model),
            _h_exchange("allgather"), stream, M_STEPS, card)
        del params, state
        torch.cuda.empty_cache()
        if model == 2:
            for row in results:
                row["launches_m_per_step"] = launches[row["name"]] / M_STEPS
            idle = [k for k in H_ROWS if launches[k] == 0]
            if idle:
                raise AssertionError(f"{label}: rows {idle} never launched")
    _m1_gates(torch, dataclasses.replace(cfg, compute_dtype="float32"),
              stream)


def _m1_gates(torch, cfg, stream, model: int = 2, W: int = 2,
              n_steps: int = M_STEPS, label: str = "M1"):
    """``n_steps`` steps of ``cfg`` (float32), each from model size 1's
    state, on ``LaneMesh(W, model=model)`` and ``LaneMesh(W, model=1)``
    under H2a's gates with ``M_TIE`` (phase M1's docstring).  The model-1
    step cuts every leaf as the model-``model`` step does (its hints: at
    16 an embedding whose vocabulary does not split is cut on d, at 1 on
    V), so the gates hold the sharded forward and backward, not another
    selection."""
    import dataclasses

    from repro_torch.core.distributed import leaf_cut
    from repro_torch.core.engine import velocity_accumulate
    from repro_torch.core.paramspace import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params

    steps = {m: build_train_step(cfg, LaneMesh(W, "cuda", model=m),
                                 _h_exchange("allgather"), lr=H_LR,
                                 remat=False) for m in (model, 1)}
    steps[1] = dataclasses.replace(steps[1], hints=steps[model].hints)
    one = steps[1]
    W, mom = one.mesh.size, H_MOMENTUM
    params = init_params(cfg, seed=0, device="cuda")
    paths = tree_flatten(params)[1]
    state = one.init_state(params)
    excused = total = 0
    worst = [0.0, 0.0]

    def clone(tree):
        leaves, p = tree_flatten(tree)
        return tree_unflatten(p, [x.clone() for x in leaves])

    def swaps(diff, lane_a, lane_gap, share, what):
        """The coordinates of ``diff`` (a leaf) outside atol 1e-5: each a
        swap on some lane.  Returns how many."""
        bad = diff > 1e-5
        n = int(bad.sum())
        if n == 0:
            return 0
        ok = torch.zeros_like(bad)
        for a, gap in zip(lane_a, lane_gap):
            hit = (gap <= M_TIE) & ((diff - a * share).abs()
                                    <= 1e-3 * a * share + 1e-6)
            ok |= hit
            if bool((hit & bad).any()):
                tie[0] = max(tie[0], float(gap[hit & bad].max()))
        if not bool(ok[bad].all()):
            no = bad & ~ok
            detail = [(float(diff[no][q]),
                       [float(gp[no][q]) for gp in lane_gap],
                       [float(a[no][q] * share) for a in lane_a])
                      for q in range(min(4, int(no.sum())))]
            raise AssertionError(
                f"{label}: {what}: {int(no.sum())} of {n} coordinates outside "
                f"atol 1e-5 are no swap: (diff, the lanes' distances from "
                f"the boundary, the lanes' shares) {detail}")
        return n

    tie = [0.0]
    for i in range(n_steps):
        batch = stream.batch(i)
        grads, _ = one.grads(params, batch)
        before_v = [x.clone() for x in tree_flatten(state.velocity)[0]]
        runs = {}
        for m in (model, 1):
            p, st = clone(params), state._replace(
                velocity=clone(state.velocity))
            p, st, loss = steps[m](p, st, batch)
            runs[m] = (p, st, float(loss))
        np.testing.assert_allclose(runs[model][2], runs[1][2], rtol=1e-4)
        for j, (x2, x1, v2, v1, u0, g, ax) in enumerate(zip(
                tree_flatten(runs[model][0])[0], tree_flatten(runs[1][0])[0],
                tree_flatten(runs[model][1].velocity)[0],
                tree_flatten(runs[1][1].velocity)[0], before_v,
                tree_flatten(grads)[0], one.hints)):
            dp, dv = (x2 - x1).abs(), (v2 - v1).abs()
            worst = [max(worst[0], float(dp.max())),
                     max(worst[1], float(dv.max()))]
            total += x1.numel()     # over the steps
            if float(dp.max()) <= 1e-5 and float(dv.max()) <= 1e-5:
                continue
            shape = tuple(x1.shape)
            c = leaf_cut(shape, ax, one.ex_cfg, W)
            lane_a, lane_gap = [], []
            for lane in range(W):
                a = velocity_accumulate(u0[lane], g[lane], momentum=mom,
                                        lr=H_LR).abs()
                rows = a.reshape(c.S, c.rest) if c.ax is None else \
                    a.movedim(c.ax, 0).reshape(c.S, c.rest)
                top = rows.topk(c.k_row + 1, dim=1).values
                tk, tk1 = top[:, c.k_row - 1:c.k_row], top[:, c.k_row:]
                gap = (torch.maximum(tk - rows, rows - tk1).clamp(min=0)
                       / torch.where(tk > 0, tk, 1.0))
                moved = shape if c.ax is None else \
                    (shape[c.ax],) + shape[:c.ax] + shape[c.ax + 1:]
                gap = gap.reshape(moved)
                lane_gap.append(gap if c.ax is None else gap.movedim(0, c.ax))
                lane_a.append(a)
            what = f"step {i} {'/'.join(paths[j])}"
            excused += swaps(dp, lane_a, lane_gap, 1.0 / W, what)
            for lane in range(W):
                swaps(dv[lane], [lane_a[lane]], [lane_gap[lane]],
                      1.0 / mom - 1.0, f"{what} velocity lane {lane}")
        params, state = runs[1][0], runs[1][1]
        del runs, grads, before_v
        torch.cuda.empty_cache()
    log(f"  {label} gates (float32 compute, model size {model} on {W} "
        f"lanes, {n_steps} steps each from model size "
        f"1's state): losses rtol 1e-4; parameters max |diff| "
        f"{worst[0]:.3g}, velocities {worst[1]:.3g}; {excused} parameter "
        f"updates outside atol 1e-5, each a support swap within "
        f"{tie[0]:.3g} (relative) of its row's boundary, of {total} "
        f"updates")
    if excused > total // 10_000:
        raise AssertionError(f"{label}: {excused} support swaps")


def phase_m1b(torch):
    """The rows at model size 2 against their plain versions: one step of
    the reduced chatglm3-6b and qwen3-moe-235b-a22b (float32) on
    LaneMesh(2, model=2), the card against the CPU under
    ``_train_gates``: the blockwise step launches rows 1-4b, the card's
    blockwise exchange fed the CPU's gradients gives the CPU's (plain
    versions') parameters and velocities bit for bit, and the exact step
    holds H2a's gate."""
    import dataclasses

    from repro_torch.configs import get_arch

    for arch in ("chatglm3-6b", "qwen3-moe-235b-a22b"):
        cfg = dataclasses.replace(get_arch(arch).reduced(),
                                  compute_dtype="float32")
        _train_gates(torch, cfg, f"M1b {cfg.name} model=2", model=2)


def _m2_problem(torch, mesh):
    """M2's problem on ``mesh`` (model size 2): chatglm3-6b at full width,
    1 layer, allgather-blockwise, 3 steps from the seed-0 parameters (a
    rank keeps its shards).  Returns (losses, digests of the local shards
    of the parameters and the velocity, resident and reckoned bytes)."""
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import sharding
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import abstract_params, init_params

    cfg = _h_cfg(1)
    step = build_train_step(cfg, mesh, _h_exchange("allgather"), lr=H_LR,
                            remat=False)
    params = init_params(cfg, seed=0, device="cuda")
    specs = sharding.param_specs(cfg, abstract_params(cfg), 2)
    if not mesh.model.lanes:
        params = sharding.shard_params(params, specs, mesh.model.rank, 2)
        torch.cuda.empty_cache()
    state = step.init_state(params)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    reckoned = sum(x.numel() * x.element_size()
                   for x in tree_leaves(params) + tree_leaves(state.velocity)
                   + tree_leaves(state.m_shard) + tree_leaves(state.v_shard))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                         batch_size=4 * mesh.size, seed=0, device="cuda")
    losses = []
    for i in range(3):
        params, state, loss = step(params, state, stream.batch(i))
        losses.append(float(loss))
    return (losses, _digests(torch, tree_leaves(params)
                             + tree_leaves(state.velocity)),
            resident, reckoned, params, state, specs)


def m2_rank(rank: int, world: int, init_method: str, out: str) -> None:
    """One rank of M2 (run by ``phase_m2`` in a process of its own):
    M2's problem over a (2, 2) ProcessMesh; writes JSON."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import init_process_mesh

    mesh = init_process_mesh(rank, world, init_method, "cuda", model=2)
    t0 = time.perf_counter()
    losses, digests, resident, reckoned, *_ = _m2_problem(torch, mesh)
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps(dict(
        losses=losses, digests=digests, seconds=time.perf_counter() - t0,
        resident=resident, reckoned=reckoned,
        peak=torch.cuda.max_memory_allocated(), staged=mesh.staged,
        cell=[mesh.rank, mesh.model.rank])))
    mesh.close()
    torch.distributed.destroy_process_group()


def phase_m2(torch, ref):
    """Four processes on the one card, a (2 data, 2 model) ProcessMesh
    over gloo (staged operands), 3 allgather steps of chatglm3-6b at full
    width, 1 layer: each rank's shards of the parameters and of its
    lane's velocity bit-equal to an in-process LaneMesh(2, model=2) run's,
    the losses equal, and each rank's resident bytes after loading its
    shards and zero state within 1% of their reckoned bytes."""
    import tempfile

    from repro_torch.core.paramspace import tree_flatten
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import LaneMesh

    world = 4
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
             " chip_smoke.m2_rank(int(sys.argv[2]), int(sys.argv[3]), "
             "sys.argv[4], sys.argv[5])", str(ROOT), str(r), str(world),
             f"file://{tmp}/rendezvous", f"{tmp}/rank{r}.json"],
            cwd=ROOT, env=_child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=400)[0])
        finally:
            for proc in procs:
                proc.kill()
        for r, (proc, text) in enumerate(zip(procs, outs)):
            if proc.returncode != 0:
                for line in text.strip().splitlines()[-15:]:
                    log(f"  M2 rank {r} | {line}")
                raise AssertionError(f"M2: rank {r} exited {proc.returncode}")
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
                 for r in range(world)]
    log(f"  M2: {world} ranks in {time.perf_counter() - t0:.1f} s (process "
        f"start-up included), staged {[r['staged'] for r in ranks]}; train "
        f"{[round(r['seconds'], 2) for r in ranks]} s; peak "
        f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB a rank")
    for r in ranks:
        log(f"  M2 rank cell {r['cell']}: resident {r['resident']} bytes "
            f"after its shards and zero state, reckoned {r['reckoned']} "
            f"({r['resident'] / r['reckoned']:.4f})")
        if abs(r["resident"] / r["reckoned"] - 1) > 0.01:
            raise AssertionError(f"M2: rank {r['cell']} holds "
                                 f"{r['resident']} bytes, not its shards' "
                                 f"{r['reckoned']}")
    ref["m2_resident"] = [r["resident"] for r in ranks]
    torch.cuda.reset_peak_memory_stats()
    losses, _, resident, reckoned, params, state, specs = _m2_problem(
        torch, LaneMesh(2, "cuda", model=2))
    log(f"  M2 lanes: losses {losses}; resident {resident} bytes (whole "
        f"leaves); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    spec_leaves = tree_flatten(specs)[0]
    p_leaves = tree_flatten(params)[0]
    v_leaves = tree_flatten(state.velocity)[0]
    for r, got in enumerate(ranks):
        d, m = got["cell"]
        want = _digests(torch, [
            sharding.shard_leaf(x, s, m, 2) for x, s in
            zip(p_leaves, spec_leaves)] + [
            sharding.shard_leaf(v[d:d + 1], (None,) + s, m, 2)
            for v, s in zip(v_leaves, spec_leaves)])
        if got["digests"] != want or got["losses"] != losses:
            raise AssertionError(f"M2: rank {r} (cell {got['cell']}) differs "
                                 f"from the lanes: losses {got['losses']} vs "
                                 f"{losses}")
    log("  M2: every rank's shards of the parameters and of its lane's "
        "velocity bit-equal to the LaneMesh(2, model=2) run's (SHA-256 of "
        "every leaf), losses equal")
    log("  M2 over NCCL with one rank a card, and qwen3-moe-235b-a22b's "
        "full-width one-layer step at model size 4: unverified (one card)")


def _m_generate(torch, cfg, label, model, keep: bool = False):
    """``cfg`` on LaneMesh(1, model=model): prefill I1's prompt (B 16 x
    1,024) through ``build_prefill_step`` and 64 greedy decode steps
    through ``build_serve_step``: prefill ms and decode ms a step (median,
    CUDA events), peak memory; finite logits, ids in range.  Returns the
    median ms, and with ``keep`` each step's last-position logits (B, V)
    float32 on the host."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import init_params, prefill

    mesh = LaneMesh(1, "cuda", model=model)
    pre = build_prefill_step(cfg, mesh, shape=InputShape(
        "p", I_PROMPT, I_BATCH, "prefill"))
    srv = build_serve_step(cfg, mesh, shape=InputShape(
        "d", I_PROMPT + I_GEN, I_BATCH, "decode"))
    params = pre.local_params(init_params(cfg, seed=0, device="cuda"))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (I_BATCH, I_PROMPT)).astype(np.int32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pre_ms = []
    for _ in range(2):      # the first call warms the matmuls up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, caches, _ = prefill(params, prompt, cfg,
                                    max_len=I_PROMPT + I_GEN, tp=mesh.model)
        ev[1].record()
        torch.cuda.synchronize()
        pre_ms.append(ev[0].elapsed_time(ev[1]))
    tokens = [logits[:, -1].argmax(-1)]
    finite = [torch.isfinite(logits).all()]
    seq = [logits[:, -1].float()] if keep else []
    events = []
    for t in range(I_GEN - 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, caches = srv(params, caches, tokens[-1][:, None].to(
            torch.int32), I_PROMPT + t)
        ev[1].record()
        events.append(ev)
        tokens.append(logits[:, 0].argmax(-1))
        finite.append(torch.isfinite(logits).all())
        if keep:
            seq.append(logits[:, 0].float())
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    out = torch.stack(tokens, dim=1).cpu()
    log(f"  {label} model={model}: prefill {pre_ms[1]:.3f} ms (first call "
        f"{pre_ms[0]:.3f}); decode {statistics.median(step_ms):.3f} ms a "
        f"step (median of steps 1-{I_GEN - 1}, CUDA events); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(bool(f) for f in finite) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label} model={model}: non-finite logits or "
                             f"ids out of range")
    if keep:
        return statistics.median(step_ms), [x.cpu() for x in seq]
    return statistics.median(step_ms)


def phase_m3(torch, card):
    """Prefill and decode at model size 2: chatglm3-6b and qwen3-moe-235b-
    a22b at their published widths (2 layers) with I1's prompt, each
    beside model size 1 ([card] numbers); then the reduced ones, card
    against CPU at model size 2 under I3's gates (float32 and bf16)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import _local_params
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.models import init_params

    for arch in ("chatglm3-6b", "qwen3-moe-235b-a22b"):
        cfg = dataclasses.replace(get_arch(arch), n_layers=2)
        ms = {m: _m_generate(torch, cfg, f"M3 {arch}", m) for m in (2, 1)}
        torch.cuda.empty_cache()
        log(f"  M3 {arch} [{card}]: decode {ms[2]:.3f} ms a step at model "
            f"size 2, {ms[1]:.3f} at 1 ({ms[2] / ms[1]:.3f}x)")
    for arch in ("chatglm3-6b", "qwen3-moe-235b-a22b"):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_arch(arch).reduced(),
                                      compute_dtype=dtype)
            label = f"M3 {cfg.name} {dtype} model=2"
            prompt = np.random.default_rng(3).integers(
                0, cfg.vocab_size, (I3_BATCH, I3_PROMPT)).astype(np.int32)
            params = init_params(cfg, seed=0, device="cpu")
            runs = []
            for dev in ("cpu", "cuda"):
                mesh = LaneMesh(1, dev, model=2)
                runs.append(_greedy_run(
                    torch, _local_params(params_from_numpy(params, dev), cfg,
                                         mesh), prompt, cfg, dev,
                    tp=mesh.model))
            agreed, worst = _greedy_compare(label, *runs, I3_MARGIN[dtype],
                                            logits_gate=dtype == "float32")
            log(f"  {label}: {agreed} of {I3_BATCH * (I3_STEPS + 1)} greedy "
                f"tokens equal before the sequences' first disagreements; "
                f"logits max |card - CPU| {worst:.3e} over them")


def phase_m4():
    """``launch.train --devices 8`` (the reference's (4, 2) mesh) and
    ``launch.serve --role decode --devices 4`` on the card, both exit 0
    and print their meshes."""
    out = _run_launcher("M4 train", "repro_torch.launch.train",
                        ["--devices", "8", "--steps", "3"], _child_env())
    if "mesh={'data': 4, 'model': 2}" not in out:
        raise AssertionError("M4: the train launcher did not build (4, 2)")
    out = _run_launcher("M4 serve", "repro_torch.launch.serve",
                        ["--role", "decode", "--devices", "4"], _child_env())
    if "mesh={'data': 1, 'model': 4}" not in out:
        raise AssertionError("M4: the decode launcher's mesh is not (1, 4)")
    _check_decode_rows("M4 serve", out, "chatglm3-6b")


# ---------------------------------------------------------------------------
# phase N: the embedding on d at model size 16, the examples, the roofline
# and the dry run
# ---------------------------------------------------------------------------

N_MODEL = 16        # the model size of the reference's production meshes
N_W = 2             # N1's data lanes: at 16 shards memory allows 2
N_STEPS = 2
# (arch, layers of the published depth): their vocabularies (50,280;
# 73,448) do not split over 16 shards, so the spec puts the embedding on d
N1_FAMILIES = (("mamba2-780m", 2), ("minicpm3-4b", 2))
N2_EXAMPLES = (("federated_noniid_torch.py", []),
               ("serve_decode_torch.py", []),
               ("bandwidth_study_torch.py", ["--quick"]))
M2_RECKONED = 2_946_615_296     # phase M2's rank: its shards' bytes
N_PREDICTION = (
    "N1 mamba2-780m and minicpm3-4b (2 layers each, embedding on d, "
    "minicpm3's 40 MLA heads gathered whole) on LaneMesh(2, model=16) "
    "against model=1: a train step 1.5-4x model 1's ms (16 shards' small "
    "GEMMs on lanes, host-bound), peak +10-40%; float32 within M1's gates "
    "(swaps within M_TIE, at most 1 in 10,000); decode 3-10x model 1's ms "
    "a step (16x the launches of a sharded block), prefill 1-3x; greedy "
    "tokens under I3's bf16 gate; rows 1-4b bit-equal to their plain "
    "versions at model 16. N2 the three examples exit 0 together in 15-40 "
    "s, federated's bytes its frames', serve_decode's replica and chain "
    "bit-identical; launches: federated rows 1 and 5 (int8 up), "
    "serve_decode row 1, bandwidth rows 1, 5 and 6 (tern). N3 the dryrun "
    "reckons M2's rank at exactly 2,946,615,296 bytes, every M2 rank "
    "within 1% of it; FlopCounterMode on meta equals the card's count; "
    "H1's step (~370 ms) against a compute term of ~12 ms and a memory "
    "term of ~11 ms, model_flops over step x peak ~0.03; phase N 60-150 s")


def phase_n(torch, results, card, ref):
    """N1 the embedding split on d at model size 16 (mamba2-780m,
    minicpm3-4b at their published widths); N2 the three examples on the
    card; N3 the roofline and the dryrun against the card."""
    log(f"  N prediction: {N_PREDICTION}")
    phase_n1(torch, results, card)
    torch.cuda.empty_cache()
    phase_n2(results)
    torch.cuda.empty_cache()
    phase_n3(torch, card, ref)


def _n1_small(arch):
    """``arch`` reduced at d 1,024 and vocabulary 1,000 (which 16 does not
    divide, so the embedding goes on d), float32; minicpm3 at 8 MLA heads,
    which do not split over 16 either."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch).reduced(d_model=1024, vocab=1000)
    if cfg.attention == "mla":
        cfg = dataclasses.replace(cfg, n_heads=8)
    return dataclasses.replace(cfg, compute_dtype="float32")


def phase_n1(torch, results, card):
    """Each of N1_FAMILIES at its published widths and vocabulary (2
    layers): N_STEPS blockwise allgather train steps (bf16) on
    LaneMesh(N_W, model=16) and on LaneMesh(N_W, model=1), the split, peak
    and launches of each (rows 1-4a must launch at 16); then M1's float32
    gates over N_STEPS steps at model 16 against 1; prefill of I1's
    prompt and 64 greedy tokens on LaneMesh(1, model=16) and (1, model=1),
    ms and peak of each, the model-16 run's logits and tokens held to the
    model-1 run's under I3's gates; then ``_train_gates`` at model 16 on a
    reduced model of the same layout (rows 1-4b on the card bit-equal to
    their plain versions on the CPU)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.paramspace import tree_flatten
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.models.model import abstract_params

    counts = {}
    for arch, layers in N1_FAMILIES:
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        specs = dict(zip(*reversed(tree_flatten(sharding.param_specs(
            cfg, abstract_params(cfg), N_MODEL)))))
        log(f"  N1 {arch}: vocabulary {cfg.vocab_size}, d {cfg.d_model}: "
            f"embedding {specs[('embed', 'table')]}, lm_head "
            f"{specs.get(('lm_head', 'w'), 'tied')} at model size "
            f"{N_MODEL}")
        if specs[("embed", "table")] != (None, "model"):
            raise AssertionError(f"N1 {arch}: the embedding is not on d")
        stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                             batch_size=H_BATCH, seed=0, device="cuda")
        for model in (N_MODEL, 1):
            label = f"N1 {arch} model={model}"
            params, state, _, launches, _ = _h_run(
                torch, label, cfg, LaneMesh(N_W, "cuda", model=model),
                _h_exchange("allgather"), stream, N_STEPS, card)
            del params, state
            torch.cuda.empty_cache()
            if model == N_MODEL:
                counts[arch] = launches
                idle = [k for k in H_ROWS if launches[k] == 0]
                if idle:
                    raise AssertionError(f"{label}: rows {idle} never "
                                         f"launched")
        _m1_gates(torch, dataclasses.replace(cfg, compute_dtype="float32"),
                  stream, model=N_MODEL, W=N_W, n_steps=N_STEPS,
                  label=f"N1 {arch}")
        torch.cuda.empty_cache()
        runs = {m: _m_generate(torch, cfg, f"N1 {arch}", m, keep=True)
                for m in (N_MODEL, 1)}
        torch.cuda.empty_cache()
        label = f"N1 {arch} {cfg.compute_dtype} model={N_MODEL}"
        agreed, worst = _greedy_compare(
            label, runs[1][1], runs[N_MODEL][1], I3_MARGIN[cfg.compute_dtype],
            logits_gate=cfg.compute_dtype == "float32")
        log(f"  {label} [{card}]: decode {runs[N_MODEL][0]:.3f} ms a step at "
            f"model size {N_MODEL}, {runs[1][0]:.3f} at 1 "
            f"({runs[N_MODEL][0] / runs[1][0]:.3f}x); {agreed} of "
            f"{I_BATCH * I_GEN} greedy tokens equal to model size 1's before "
            f"the sequences' first disagreements, logits max |diff| "
            f"{worst:.3e} over them")
        del runs
        _train_gates(torch, _n1_small(arch), f"N1 train {arch} reduced "
                     f"model={N_MODEL}", model=N_MODEL)
        torch.cuda.empty_cache()
    for row in results:
        row["launches_n1_per_step"] = {arch: c[row["name"]] / N_STEPS
                                       for arch, c in counts.items()}


def phase_n2(results):
    """The three ``examples/*_torch.py`` on the card at their defaults
    (the bandwidth study ``--quick``), as three processes at once: each
    exits 0 (each checks itself: federated's measured bytes are its served
    rounds' frames, serve_decode's replica and restored delta chain the
    server's final arena bit for bit); their launch counters printed."""
    import ast

    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "examples" / name),
                               *flags], cwd=ROOT, env=_child_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for name, flags in N2_EXAMPLES]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=400)[0])
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    log(f"  N2: {len(procs)} examples at once, {time.perf_counter() - t0:.1f}"
        f" s (process start-up included)")
    launches = {}
    for (name, _), proc, out in zip(N2_EXAMPLES, procs, outs):
        for line in out.strip().splitlines()[-9:]:
            log(f"  N2 {name} | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"N2 {name}: exited {proc.returncode}")
        counted = [line for line in out.splitlines()
                   if line.startswith("kernel launches: ")]
        if not counted:
            raise AssertionError(f"N2 {name}: no launch counts printed")
        launches[name] = ast.literal_eval(counted[-1].split(": ", 1)[1])
    serve = outs[1]
    for claim in ("final model bit-identical to server: True",
                  "delta-chain restore bit-identical: True"):
        if claim not in serve:
            raise AssertionError(f"N2 serve_decode: no {claim!r}")
    if "frames: " not in outs[0]:
        raise AssertionError("N2 federated: no frame bytes printed")
    if len([line for line in outs[2].splitlines()
            if line.startswith("fig4/")]) != 8:
        raise AssertionError("N2 bandwidth: not the study's 8 rows")
    for name, counts in launches.items():
        log(f"  N2 {name}: launches {counts}")
    for row in results:
        row["launches_n2"] = {name.split("_torch")[0]: counts[row["name"]]
                              for name, counts in launches.items()}


def phase_n3(torch, card, ref):
    """The dryrun and the roofline against the card: ``dryrun.reckon`` of
    M2's problem (chatglm3-6b, 1 layer, (2, 2), allgather-blockwise) must
    give M2_RECKONED bytes of parameters, velocity and exchange state,
    and every M2 rank's measured resident bytes must lie within 1% of it;
    ``FlopCounterMode`` over H1's gradients on the meta device must count
    what it counts over the real tensors on the card; H1's step (median of
    steps 1-2, CUDA events) is printed beside the roofline's three terms,
    and ``model_flops / (step s * peak)`` must read under 1.05."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.paramspace import tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import LaneMesh, MeshShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import abstract_params, init_params

    r = dryrun.reckon(_h_cfg(1), InputShape("m2", H_SEQ, 8, "train"),
                      MeshShape(("data", "model"), (2, 2)),
                      _h_exchange("allgather"), remat=False)
    parts = r["parts"]
    state = parts["params"] + parts["velocity"] + parts["exchange_state"]
    log(f"  N3 dryrun of M2's problem: {parts} ({state} bytes of "
        f"parameters, velocity and exchange state a rank)")
    if state != M2_RECKONED:
        raise AssertionError(f"N3: the dryrun reckons {state} bytes, M2's "
                             f"shards hold {M2_RECKONED}")
    if "m2_resident" not in ref:
        raise AssertionError("N3: phase M2 left no ranks' resident bytes")
    shares = [x / state for x in ref["m2_resident"]]
    log(f"  N3: M2's ranks measured {ref['m2_resident']} resident bytes "
        f"({[round(x, 5) for x in shares]} of the dryrun's) [{card}]")
    if any(abs(x - 1) > 0.01 for x in shares):
        raise AssertionError("N3: an M2 rank is not within 1% of the dryrun")

    cfg = _h_cfg(H_LAYERS)
    step = build_train_step(cfg, LaneMesh(H_W, "cuda"),
                            _h_exchange("allgather"), lr=H_LR, remat=False)
    params = init_params(cfg, seed=0, device="cuda")
    state = step.init_state(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=H_SEQ,
                         batch_size=H_BATCH, seed=0, device="cuda")
    batch = stream.batch(0)
    on_card = roofline.count_flops(lambda: step.grads(params, batch))
    meta_batch = {k: v.to("meta") for k, v in batch.items()}
    on_meta = roofline.count_flops(
        lambda: step.grads(abstract_params(cfg), meta_batch))
    log(f"  N3 FlopCounterMode over H1's gradients: {on_card} on the card, "
        f"{on_meta} on the meta device")
    if on_card != on_meta:
        raise AssertionError("N3: the meta count differs from the card's")
    ms = []
    for i in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, state, _ = step(params, state, stream.batch(i))
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    step_s = statistics.median(ms[1:]) / 1e3
    resident = sum(x.numel() * x.element_size() for x in
                   tree_leaves(params) + tree_leaves(state.velocity))
    shapes = [p.shape for p in tree_leaves(params)]
    shape = InputShape("h1", H_SEQ, H_BATCH, "train")
    rep = roofline.report(
        arch=cfg.name, shape=shape, mesh_name=f"LaneMesh({H_W})", cfg=cfg,
        n_devices=1, flops=on_card,
        nbytes=2 * resident + batch["tokens"].numel() * 4,
        wire=roofline.wire_bytes(step.ex_cfg, H_W, shapes, step.hints),
        collective_counts={})
    share = rep.model_flops / (step_s * roofline.PEAK_FLOPS[
        cfg.compute_dtype])
    log(f"  N3 H1 [{card}]: step {step_s * 1e3:.3f} ms (median of steps 1-2,"
        f" CUDA events; {[round(x, 3) for x in ms]}); roofline at the H100 "
        f"SXM peaks: compute {rep.compute_s * 1e3:.3f} ms ({on_card:.4e} "
        f"FLOPs at {cfg.compute_dtype}), memory {rep.memory_s * 1e3:.3f} ms "
        f"(a lower bound of {2 * resident} bytes), collective "
        f"{rep.collective_s * 1e3:.3f} ms ({rep.wire_bytes_per_device:.4e} "
        f"wire bytes a worker, NVLink 4 each way); model_flops "
        f"{rep.model_flops:.4e} / (step s x peak) = {share:.4f}")
    if not share < 1.05:
        raise AssertionError(f"N3: model_flops share {share} above 1.05")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = torch.cuda.get_device_name(0)
    log(f"card: {smi.stdout.strip()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_SECONDS:.2f} s)")
    rate = card_rate(card)
    timer = Timer(torch)

    results: list = []
    ref: dict = {}
    failed = []
    for phase, fn in (("kernels", lambda: kernel_phase(torch, timer, rate,
                                                       results)),
                      ("a", lambda: phase_a(torch)),
                      ("b", lambda: phase_b(torch, results, ref)),
                      ("e", lambda: phase_e(torch, results, ref)),
                      ("c", lambda: phase_c(torch, results, ref)),
                      ("d", lambda: phase_d(torch, results, ref)),
                      ("f", lambda: phase_f(torch, results, ref)),
                      ("g", lambda: phase_g(torch, results, ref)),
                      ("h", lambda: phase_h(torch, results,
                                            smi.stdout.strip())),
                      ("i", lambda: phase_i(torch, smi.stdout.strip(),
                                            rate)),
                      ("j", lambda: phase_j(torch, results,
                                            smi.stdout.strip(), rate)),
                      ("k", lambda: phase_k(torch, results,
                                            smi.stdout.strip(), rate)),
                      ("l", lambda: phase_l(torch, results,
                                            smi.stdout.strip(), rate)),
                      ("m", lambda: phase_m(torch, results,
                                            smi.stdout.strip(), ref)),
                      ("n", lambda: phase_n(torch, results,
                                            smi.stdout.strip(), ref))):
        log(f"== phase {phase}")
        t0 = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
        except Exception as exc:  # report every phase, then fail
            import traceback
            traceback.print_exc()
            failed.append(f"{phase}: {exc!r}")
        # hand the phase's cached blocks back: phase D's subprocesses
        # share the card
        torch.cuda.empty_cache()
        log(f"== phase {phase}: {time.perf_counter() - t0:.1f} s")
    # every kernel row needs its launch count from its main-path run
    from repro_torch import kernels
    if len(results) != len(kernels.KERNELS) \
            or any("launches" not in row for row in results):
        failed.append("kernel rows lack the main path's launch counts")
    if failed:
        print("chip_smoke FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         **{k: v for k, v in row.items() if k not in keys}}
        for row in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
