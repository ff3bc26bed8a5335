"""Attention blocks: GQA with full, sliding-window and local:global masks
(PyTorch port of the training forward of ``repro.models.attention``; MLA
and the decode caches are not ported yet).

The forward runs query-block *chunked* attention, so the score matrix
never holds more than ``(chunk_q, S_kv)`` per head, and sliding-window
layers slice K/V to the live window of each chunk (O(S * window), not
O(S^2)), as the reference's.  The reference's einsums take the compute
dtype with float32 accumulation; here the operands are cast to float32
first, which computes the same products exactly (a bf16 x bf16 product is
exact in float32).
"""
from __future__ import annotations

import torch

from . import rope as rope_lib
from .config import ModelConfig
from .layers import Init, linear, linear_init

NEG_INF = -1e30


def gqa_init(init: Init, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": linear_init(init, d, cfg.n_heads * hd, dtype=cfg.pdtype,
                          bias=cfg.qkv_bias),
        "wk": linear_init(init, d, cfg.n_kv_heads * hd, dtype=cfg.pdtype,
                          bias=cfg.qkv_bias),
        "wv": linear_init(init, d, cfg.n_kv_heads * hd, dtype=cfg.pdtype,
                          bias=cfg.qkv_bias),
        "wo": linear_init(init, cfg.n_heads * hd, d, dtype=cfg.pdtype),
    }


def _apply_positions(cfg: ModelConfig, q, k, positions, *, layer_kind: str):
    theta = cfg.rope_theta
    if layer_kind == "attn_local" and cfg.rope_theta_local is not None:
        theta = cfg.rope_theta_local
    if cfg.rope == "none":
        return q, k
    if cfg.rope == "mrope":
        return rope_lib.mrope(q, k, positions, theta=theta)
    rd = int(cfg.hd * cfg.rotary_pct)
    rd -= rd % 2
    return rope_lib.standard_rope(q, k, positions, theta=theta,
                                  rotary_dim=rd)


def gqa_forward(params, x, positions, cfg: ModelConfig, *,
                layer_kind: str = "attn", chunk_q: int = 512):
    """Training GQA attention. x: (B,S,d) -> (B,S,d)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KH
    q = linear(params["wq"], x).reshape(B, S, H, hd)
    k = linear(params["wk"], x).reshape(B, S, KH, hd)
    v = linear(params["wv"], x).reshape(B, S, KH, hd)
    q, k = _apply_positions(cfg, q, k, positions, layer_kind=layer_kind)
    windowed = layer_kind == "attn_local" or cfg.attention == "sliding"
    window = cfg.window if windowed else None

    C = min(chunk_q, S)
    while S % C:
        C -= 1
    scale = hd ** -0.5
    kt = k.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]   # (B,KH,1,hd,S)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]   # (B,KH,1,S,hd)
    qg = q.reshape(B, S, KH, G, hd).permute(0, 2, 3, 1, 4)    # (B,KH,G,S,hd)
    kv_pos = torch.arange(S, device=x.device)
    outs = []
    for start_q in range(0, S, C):
        q_pos = start_q + torch.arange(C, device=x.device)
        ks, vs, kp = kt, vf, kv_pos
        if window is not None and window + C < S:
            # slice K/V to [chunk_start - window, chunk_start + C)
            kw = window + C
            start = min(max(start_q - window, 0), S - kw)
            ks = kt[..., start:start + kw]
            vs = vf[..., start:start + kw, :]
            kp = start + torch.arange(kw, device=x.device)
        mask = kp[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kp[None, :] > q_pos[:, None] - window
        s = (qg[:, :, :, start_q:start_q + C].to(torch.float32) @ ks) * scale
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        # the reference rounds p to the compute dtype before the PV matmul
        outs.append(p.to(v.dtype).to(torch.float32) @ vs)  # (B,KH,G,C,hd)
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    return linear(params["wo"], out.to(x.dtype))


def mla_forward(params, x, positions, cfg: ModelConfig, **_):
    raise NotImplementedError(
        "MLA attention (minicpm3) is not ported yet (ROADMAP queue 1 "
        "item 4)")
