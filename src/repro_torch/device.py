"""The port's one device rule: entry points run on the card unless the
caller asks for the CPU.  ``None`` means ``cuda``; asking for CUDA where
there is none raises, and nothing carries on silently on the CPU."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def from_host(array, device) -> torch.Tensor:
    """A small host array (worker ids, learning rates) as a tensor on
    ``device``.  To the card it goes through pinned memory with a
    non-blocking copy: a plain ``.to("cuda")`` from pageable memory waits
    for the stream to drain, a host sync in the middle of the loop.

    Raises while the current stream captures a CUDA graph: the graph would
    bake in the temporary pinned buffer and replay a copy of what it held
    at capture."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cpu":
        return t
    if t.numel() == 0:     # an empty shard's frame: nothing to copy
        return torch.empty(t.shape, dtype=t.dtype, device=device)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("from_host under CUDA graph capture: the graph "
                           "would replay the capture's host values")
    return t.pin_memory().to(device, non_blocking=True)
