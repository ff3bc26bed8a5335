"""The modality frontends' stand-ins (PyTorch port of
``repro.models.multimodal``).

For the [vlm] and [audio] architectures the model is the decoder alone:
the caller supplies precomputed patch or frame embeddings of the right
shape (as a ViT/SigLIP tower or an EnCodec feature extractor would).
:func:`merge_frontend` puts them in the token stream, and for Qwen2-VL
:func:`mrope_positions` builds the three-stream M-RoPE position ids of a
square patch grid.
"""
from __future__ import annotations

import math

import torch

from .config import ModelConfig


def merge_frontend(cfg: ModelConfig, token_embeds, frontend_embeds):
    """Replace the first ``frontend_tokens`` positions with the frontend's
    embeddings, cast to the token embeddings' dtype.

    token_embeds: (B, S, d); frontend_embeds: (B, n_front, d).  A sequence
    shorter than the frontend is refused: the merge would not keep its
    length (the reference fails on it too, at the positions)."""
    n = cfg.frontend_tokens
    if n == 0 or frontend_embeds is None:
        return token_embeds
    if token_embeds.shape[1] < n:
        raise ValueError(f"a sequence of {token_embeds.shape[1]} positions "
                         f"is shorter than the frontend's {n}")
    return torch.cat([frontend_embeds.to(token_embeds.dtype),
                      token_embeds[:, n:]], dim=1)


def _grid(cfg: ModelConfig) -> tuple[int, int]:
    """(n, g): the frontend's positions and the side of its square grid."""
    n = cfg.frontend_tokens
    return n, max(1, int(math.sqrt(max(n, 1))))


def mrope_positions(cfg: ModelConfig, batch: int, seq_len: int, *,
                    device) -> torch.Tensor:
    """(3, B, S) int32 (t, h, w) position ids: a square patch grid for the
    stub image, then text positions (the Qwen2-VL scheme: h and w scan the
    grid on patches, all three streams advance together on text, from the
    grid's side on)."""
    n, g = _grid(cfg)
    off = g if n > 0 else 0
    idx = torch.arange(seq_len, device=device)
    in_img = idx < n
    row = torch.where(in_img, idx // g, 0)
    col = torch.where(in_img, idx % g, 0)
    text_pos = off + (idx - n)
    t = torch.where(in_img, 0, text_pos)
    h = torch.where(in_img, row, text_pos)
    w = torch.where(in_img, col, text_pos)
    pos = torch.stack([t, h, w], dim=0).to(torch.int32)       # (3, S)
    return pos[:, None, :].expand(3, batch, seq_len)


def mrope_text_position(cfg: ModelConfig, pos: int) -> int:
    """The decode-time rotary position (t == h == w) of a text token at
    absolute position ``pos`` (generation is past the frontend)."""
    n, g = _grid(cfg)
    return (g if n > 0 else 0) + pos - n
