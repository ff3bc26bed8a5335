"""The four assigned input shapes and per-(arch, shape) input specs
(PyTorch port of ``repro.configs.shapes``).

``input_specs`` returns, for each model input, its ``(shape, dtype)``: the
port's stand-in for the reference's ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import config as mcfg


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode
    long: bool = False  # long-context decode (sliding-window substitution)


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode", long=True),
}


def input_specs(cfg: mcfg.ModelConfig, shape: InputShape) -> dict:
    """``{name: (shape, dtype)}`` of every model input of one
    (architecture, input shape).  Decode's caches are not ported yet."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": ((B, S), torch.int32)}
        if cfg.frontend_tokens:
            specs["frontend_embeds"] = (
                (B, cfg.frontend_tokens, cfg.d_model), cfg.cdtype)
        return specs
    raise NotImplementedError(
        "decode input specs need the KV and SSM caches, which the port "
        "does not have yet (ROADMAP queue 1 item 4)")
