"""Checkpoints of the port (PyTorch port of ``repro.checkpoint``): pytree
``.npz`` snapshots and sparse delta chains over the flat arena, in the
reference's file formats."""
from .checkpoint import load_checkpoint, save_checkpoint
from .delta import (DeltaCheckpointWriter, compact, load_delta_checkpoint,
                    read_manifest)

__all__ = ["load_checkpoint", "save_checkpoint", "DeltaCheckpointWriter",
           "load_delta_checkpoint", "read_manifest", "compact"]
