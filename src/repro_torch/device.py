"""The port's one device rule: entry points run on the card unless the
caller asks for the CPU.  ``None`` means ``cuda``; asking for CUDA where
there is none raises, and nothing carries on silently on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
