"""The four assigned input shapes and per-(arch, shape) input specs
(PyTorch port of ``repro.configs.shapes``).

``input_specs`` returns, for each model input, its ``(shape, dtype)``: the
port's stand-in for the reference's ``jax.ShapeDtypeStruct``;
``concrete_inputs`` makes the inputs themselves.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import config as mcfg
from repro_torch.models.model import init_caches


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
    (architecture, input shape); decode's ``caches`` is the tree of
    ``init_caches`` (dicts and cache named tuples) with a ``(shape,
    dtype)`` pair for each leaf."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": ((B, S), torch.int32)}
        if cfg.frontend_tokens:
            specs["frontend_embeds"] = (
                (B, cfg.frontend_tokens, cfg.d_model), cfg.cdtype)
        return specs
    # decode: one new token against a seq_len cache
    caches = init_caches(cfg, B, S, long_mode=shape.long, device="meta")
    return {
        "token": ((B, 1), torch.int32),
        "pos": ((), torch.int32),
        "caches": _leaf_specs(caches),
    }


def _leaf_specs(tree):
    if isinstance(tree, dict):
        return {key: _leaf_specs(val) for key, val in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_leaf_specs(leaf) for leaf in tree))
    return tuple(tree.shape), tree.dtype


def concrete_inputs(cfg: mcfg.ModelConfig, shape: InputShape, *, seed=0,
                    device=None) -> dict:
    """The inputs themselves on ``device`` (None = the card): tokens from a
    ``torch.Generator`` seeded with ``seed``; for decode zero caches and
    ``pos = seq_len // 2``, a Python int."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=gen, device=device,
                                       dtype=torch.int32)}
        if cfg.frontend_tokens:
            out["frontend_embeds"] = torch.randn(
                (B, cfg.frontend_tokens, cfg.d_model), generator=gen,
                device=device).to(cfg.cdtype)
        return out
    return {
        "token": torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                               device=device, dtype=torch.int32),
        "pos": S // 2,
        "caches": init_caches(cfg, B, S, long_mode=shape.long,
                              device=device),
    }
