"""Rotary position embeddings: standard 1-D and partial/2-D (ChatGLM), with
per-layer theta (PyTorch port of ``repro.models.rope``; M-RoPE is not
ported yet).

All functions take and return ``(B, S, H, D)`` query/key tensors.  The
rotation acts on interleaved pairs ``(x0, x1) -> (-x1, x0)``, not on
halves, and the frequencies are float64 cast to float32, as the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch


def _rot_half_pairs(x):
    """Rotate pairs (x0,x1) -> (-x1, x0) over the last dim (interleaved)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _freqs(dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def _interleave2(x):
    """[a, b, ...] -> [a, a, b, b, ...]."""
    return torch.stack([x, x], dim=-1).reshape(*x.shape[:-1], -1)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for given integer positions. -> (..., dim) each."""
    inv = torch.from_numpy(_freqs(dim, theta).astype(np.float32)).to(
        positions.device)
    ang = positions[..., None].to(torch.float32) * inv  # (..., dim/2)
    return _interleave2(torch.cos(ang)), _interleave2(torch.sin(ang))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B,S,H,D); cos/sin: (B,S,D) or (S,D).  A bf16 ``x`` times the
    float32 tables computes in float32; the result is cast back."""
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return (x * cos + _rot_half_pairs(x) * sin).to(x.dtype)


def standard_rope(q, k, positions, *, theta: float = 10000.0,
                  rotary_dim: int | None = None):
    """Standard RoPE over the first ``rotary_dim`` dims of the head.

    rotary_dim < head_dim gives ChatGLM-style partial ("2d") rotary: GLM
    applies rotation to half the head dims and leaves the rest untouched.
    """
    D = q.shape[-1]
    rd = rotary_dim or D
    cos, sin = rope_cos_sin(positions, rd, theta)
    if rd == D:
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q_rot = apply_rope(q[..., :rd], cos, sin)
    k_rot = apply_rope(k[..., :rd], cos, sin)
    q = torch.cat([q_rot, q[..., rd:]], dim=-1)
    k = torch.cat([k_rot, k[..., rd:]], dim=-1)
    return q, k


def mrope(q, k, positions_tsw, *, theta: float, sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE: not ported yet."""
    raise NotImplementedError(
        "M-RoPE (qwen2-vl) is not ported yet (ROADMAP queue 1 item 3d)")
