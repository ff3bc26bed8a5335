"""Rotary position embeddings: standard 1-D, partial/2-D (ChatGLM) and
M-RoPE (Qwen2-VL's three sections), with per-layer theta (PyTorch port of
``repro.models.rope``).

All functions take and return ``(B, S, H, D)`` query/key tensors.  The
rotation acts on interleaved pairs ``(x0, x1) -> (-x1, x0)``, not on
halves, and the frequencies are float64 cast to float32, as the
reference's.  ``rope_scaling`` (``config.RopeScaling``) takes YaRN's
blended frequencies (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _rot_half_pairs(x):
    """Rotate pairs (x0,x1) -> (-x1, x0) over the last dim (interleaved)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _freqs(dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(factor) + 1`` (1 at a
    factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_freqs(dim: int, theta: float, scaling) -> np.ndarray:
    """YaRN's inverse frequencies: the pairs that turn fewer than
    ``beta_slow`` times over the original context are divided by
    ``factor``, those that turn more than ``beta_fast`` times are kept,
    and a linear ramp over the pair index blends the ones between."""
    def corr(rotations):
        return dim * math.log(scaling.original_max_position_embeddings
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(corr(scaling.beta_fast)), 0)
    high = min(math.ceil(corr(scaling.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low)
                   / (high - low), 0.0, 1.0)
    base = _freqs(dim, theta)
    return base / scaling.factor * ramp + base * (1.0 - ramp)


def _interleave2(x):
    """[a, b, ...] -> [a, a, b, b, ...]."""
    return torch.stack([x, x], dim=-1).reshape(*x.shape[:-1], -1)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float,
                 scaling=None):
    """cos/sin tables for given integer positions. -> (..., dim) each.
    Under YaRN (``scaling``) the tables are scaled by ``mscale(mscale) /
    mscale(mscale_all_dim)``."""
    freqs = (_freqs(dim, theta) if scaling is None
             else _yarn_freqs(dim, theta, scaling))
    inv = torch.from_numpy(freqs.astype(np.float32)).to(positions.device)
    ang = positions[..., None].to(torch.float32) * inv  # (..., dim/2)
    cos, sin = _interleave2(torch.cos(ang)), _interleave2(torch.sin(ang))
    if scaling is not None:
        m = (yarn_mscale(scaling.factor, scaling.mscale)
             / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    return cos, sin


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
                  rotary_dim: int | None = None, scaling=None):
    """Standard RoPE over the first ``rotary_dim`` dims of the head.

    rotary_dim < head_dim gives ChatGLM-style partial ("2d") rotary: GLM
    applies rotation to half the head dims and leaves the rest untouched.
    """
    D = q.shape[-1]
    rd = rotary_dim or D
    cos, sin = rope_cos_sin(positions, rd, theta, scaling)
    if rd == D:
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q_rot = apply_rope(q[..., :rd], cos, sin)
    k_rot = apply_rope(k[..., :rd], cos, sin)
    q = torch.cat([q_rot, q[..., rd:]], dim=-1)
    k = torch.cat([k_rot, k[..., rd:]], dim=-1)
    return q, k


def mrope(q, k, positions_tsw, *, theta: float, sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE: the first ``rd = 2 * sum(sections)`` head dims are
    split into (temporal, height, width) sections of frequency pairs, each
    rotated by its own position stream; the dims past ``rd`` are left
    untouched.

    positions_tsw: (3, B, S) int -- per-token (t, h, w) position ids.  For
    pure text all three streams are equal and M-RoPE == RoPE.  The angle is
    the float32 position of each pair's stream times the float32 frequency,
    as in :func:`rope_cos_sin`.
    """
    D = q.shape[-1]
    rd = 2 * sum(sections)
    assert rd <= D, (rd, D)
    inv = torch.from_numpy(_freqs(rd, theta).astype(np.float32)).to(q.device)
    # the section (position stream) of each frequency pair
    sec = torch.from_numpy(np.concatenate([
        np.full(s, i) for i, s in enumerate(sections)])).to(q.device)
    pos = positions_tsw.to(torch.float32).movedim(0, -1)      # (B, S, 3)
    ang = pos[..., sec] * inv                                 # (B, S, rd/2)
    cos = _interleave2(torch.cos(ang))
    sin = _interleave2(torch.sin(ang))
    q_rot = apply_rope(q[..., :rd], cos, sin)
    k_rot = apply_rope(k[..., :rd], cos, sin)
    if rd == D:
        return q_rot, k_rot
    return (torch.cat([q_rot, q[..., rd:]], dim=-1),
            torch.cat([k_rot, k[..., rd:]], dim=-1))


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Degenerate (text-only) M-RoPE position ids: all three streams
    equal, ``(3, *positions.shape)``."""
    return torch.stack([positions, positions, positions], dim=0)
