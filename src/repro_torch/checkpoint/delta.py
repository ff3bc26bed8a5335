"""Sparse delta checkpoints: a base arena plus a chain of committed diffs
(PyTorch port of ``repro.checkpoint.delta``; the files are the
reference's, byte for byte).

A delta-checkpoint directory holds the live model ARENA as

* ``base.npy``      -- the f32 ``(total,)`` arena at chain start
* ``deltas.bin``    -- an append-only log of wire-framed state deltas
* ``manifest.json`` -- offsets, sizes and versions of every delta, written
                       after each append (temp file + rename, so a torn
                       append leaves the previous manifest valid and the
                       log's tail is ignored)

Each delta is one :mod:`repro_torch.cluster.wire` DIFF message:

* a sparse single-segment ARENA frame (``mode="none"``, int32 indices
  ascending) of the entries that changed since the previous checkpoint, at
  their NEW values.  Restore is a scatter-*set*, never an add, so a
  restored arena is bit-identical to the recorded one wherever the chain
  is truncated or compacted;
* a dense frame (the codec's DENSE/DENSE_COO pick) when the changed set is
  large enough that the whole arena is cheaper: a whole-arena assignment.

The writer picks the smaller framing per append.  The changed set is IEEE
``!=``: a ``-0 -> +0`` flip is not recorded (``np.array_equal`` calls them
equal) and a NaN is always recorded again.  ``version`` is the producer's
committed-event count, carried in the DIFF envelope's ``seq`` field.

On the card the writer keeps the previous arena on the arena's device,
finds the changed set there (``arena != prev``, then ``nonzero``, which is
ascending) and encodes through the codec's ``pack_from_arena`` (one launch
of the segmented quantize); only the frame crosses to the host.  Restore
runs on ``device`` (None = the card) and returns a float32 tensor there.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from repro_torch.device import from_host, resolve_device

MANIFEST_FILE = "manifest.json"
BASE_FILE = "base.npy"
LOG_FILE = "deltas.bin"
_FORMAT = 1


def _wire():
    # lazy: keep `import repro_torch.checkpoint` free of the cluster package
    from repro_torch.cluster import wire
    return wire


class DeltaCheckpointWriter:
    """Append-only delta-checkpoint chain over a flat f32 arena tensor; the
    chain's previous arena stays on ``base``'s device.

    ``append(arena, version)`` diffs against the previously recorded
    state, writes one wire-framed delta and updates the manifest.
    """

    def __init__(self, path, base: torch.Tensor, *, version: int = 0,
                 meta: dict | None = None):
        self.path = pathlib.Path(path)
        os.makedirs(self.path, exist_ok=True)
        self._prev = base.detach().to(torch.float32).reshape(-1).clone()
        np.save(self.path / BASE_FILE, self._prev.cpu().numpy())
        self.total = int(self._prev.numel())
        self.base_version = int(version)
        self.meta = dict(meta or {})
        self._entries: list[dict] = []
        self._log = open(self.path / LOG_FILE, "wb")
        self._offset = 0
        self._write_manifest()

    # -- appending ---------------------------------------------------------

    def append(self, arena: torch.Tensor, version: int) -> dict:
        """Record ``arena`` as one committed delta; returns its manifest
        entry (``{"offset", "nbytes", "version", "k"}``)."""
        from repro_torch.core.sparsify import SparseLeaf

        wire = _wire()
        arena = arena.to(self._prev.device, torch.float32).reshape(-1)
        if arena.numel() != self.total:
            raise ValueError(f"arena size {arena.numel()} != chain total "
                             f"{self.total}")
        changed = torch.nonzero(arena != self._prev).reshape(-1)
        k = int(changed.numel())
        sparse_bytes = wire.arena_frame_bytes((k,) if k else (),
                                              self.total, "none")
        dense_bytes = int(wire.dense_frame_bytes(
            int(torch.count_nonzero(arena)), self.total))
        seq = int(version) & 0xFFFFFFFF
        if sparse_bytes <= dense_bytes:
            leaf = SparseLeaf(values=arena[changed],
                              indices=changed.to(torch.int32),
                              size=self.total)
            payload, _ = wire.encode_message(
                wire.DIFF, wire.COORDINATOR_ID, seq, [leaf],
                mode="none", seg=(k,) if k else ())
        else:
            payload, _ = wire.encode_message(
                wire.DIFF, wire.COORDINATOR_ID, seq, [arena])
        self._log.write(payload)
        self._log.flush()
        entry = {"offset": self._offset, "nbytes": len(payload),
                 "version": int(version), "k": k}
        self._offset += len(payload)
        self._entries.append(entry)
        self._prev = arena.clone()
        self._write_manifest()
        return entry

    def close(self) -> None:
        if not self._log.closed:
            self._log.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _write_manifest(self):
        _write_manifest(self.path, {
            "format": _FORMAT, "total": self.total,
            "base_version": self.base_version, "meta": self.meta,
            "deltas": self._entries})


def _write_manifest(path: pathlib.Path, manifest: dict) -> None:
    tmp = path / (MANIFEST_FILE + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=1))
    os.replace(tmp, path / MANIFEST_FILE)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def read_manifest(path) -> dict:
    manifest = json.loads((pathlib.Path(path) / MANIFEST_FILE).read_text())
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"unknown delta-checkpoint format "
                         f"{manifest.get('format')!r}")
    return manifest


def _apply_delta(arena: torch.Tensor, payload: bytes) -> torch.Tensor:
    """Assignment-apply one wire DIFF payload onto ``arena``, in place."""
    from repro_torch.core.sparsify import SparseLeaf

    wire = _wire()
    msg = wire.decode_message(payload, device=arena.device)
    if msg.type != wire.DIFF or len(msg.leaves) != 1:
        raise ValueError(f"not a delta frame: type={msg.type} "
                         f"n_leaves={len(msg.leaves)}")
    leaf = msg.leaves[0]
    if isinstance(leaf, SparseLeaf):
        arena.index_put_((leaf.indices.to(torch.int64),), leaf.values)
    else:   # dense delta: a whole-arena assignment
        arena.copy_(leaf)
    return arena


def load_delta_checkpoint(path, *, upto_version: int | None = None,
                          upto: int | None = None, device=None):
    """Restore ``(arena, version, meta)`` from a delta-checkpoint directory,
    the arena a float32 tensor on ``device`` (None = the card).

    ``upto`` truncates the chain after the first ``upto`` deltas;
    ``upto_version`` after the last delta with ``version <= upto_version``
    (both: the stricter wins).  The restored arena is bit-identical to the
    producer's arena at that point of the chain.
    """
    device = resolve_device(device)
    p = pathlib.Path(path)
    manifest = read_manifest(p)
    arena = from_host(np.load(p / BASE_FILE).astype(np.float32), device)
    if arena.numel() != manifest["total"]:
        raise ValueError(f"base arena size {arena.numel()} != manifest "
                         f"total {manifest['total']}")
    version = manifest["base_version"]
    entries = manifest["deltas"]
    if upto is not None:
        entries = entries[:max(0, int(upto))]
    with open(p / LOG_FILE, "rb") as log:
        for e in entries:
            if upto_version is not None and e["version"] > upto_version:
                break
            log.seek(e["offset"])
            payload = log.read(e["nbytes"])
            if len(payload) != e["nbytes"]:
                raise ValueError(f"torn delta at offset {e['offset']}")
            _apply_delta(arena, payload)
            version = e["version"]
    return arena, version, manifest.get("meta", {})


def compact(path, *, upto: int, device=None) -> dict:
    """Fold the first ``upto`` deltas into a new base snapshot, restoring
    the prefix on ``device`` (None = the card).

    The chain's tail (deltas past ``upto``) is kept byte for byte, so every
    restore point at or past the fold is bit-identical before and after:
    assignment semantics make the folded base exactly the arena the dropped
    prefix restored to.  Returns the rewritten manifest.
    """
    p = pathlib.Path(path)
    manifest = read_manifest(p)
    upto = max(0, min(int(upto), len(manifest["deltas"])))
    arena, version, meta = load_delta_checkpoint(p, upto=upto, device=device)
    tail = manifest["deltas"][upto:]
    with open(p / LOG_FILE, "rb") as log:
        payloads = []
        for e in tail:
            log.seek(e["offset"])
            payloads.append(log.read(e["nbytes"]))
    np.save(p / BASE_FILE, arena.cpu().numpy())
    offset, entries = 0, []
    with open(p / LOG_FILE, "wb") as log:
        for e, payload in zip(tail, payloads):
            log.write(payload)
            entries.append({**e, "offset": offset})
            offset += e["nbytes"]
    manifest = {"format": _FORMAT, "total": manifest["total"],
                "base_version": version, "meta": meta, "deltas": entries}
    _write_manifest(p, manifest)
    return manifest
