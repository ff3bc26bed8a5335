"""Attention blocks: GQA with full, sliding-window and local:global masks,
and its KV cache (PyTorch port of ``repro.models.attention``; MLA is not
ported yet).

The forward runs query-block *chunked* attention, so the score matrix
never holds more than ``(chunk_q, S_kv)`` per head, and sliding-window
layers slice K/V to the live window of each chunk (O(S * window), not
O(S^2)), as the reference's.  The reference's einsums take the compute
dtype with float32 accumulation; here the operands are cast to float32
first, which computes the same products exactly (a bf16 x bf16 product is
exact in float32).

Decode: one query token against a KV cache.  Full-attention layers keep a
linear cache of ``seq_len``; sliding-window layers keep a ring buffer of
``window`` slots, position p in slot ``p % window``.  The cache is
updated in place (the reference donates it), and its scores and PV
product are computed in float32, as the reference's einsums.
"""
from __future__ import annotations

import operator
from typing import NamedTuple

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
                layer_kind: str = "attn", chunk_q: int = 512,
                return_kv: bool = False):
    """Training/prefill GQA attention. x: (B,S,d) -> (B,S,d) (and the
    layer's :class:`KVCache` when ``return_kv``)."""
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
    out = linear(params["wo"], out.to(x.dtype))
    if not return_kv:
        return out
    L = min(cfg.window, S) if windowed else S
    kc, vc = k[:, S - L:], v[:, S - L:]
    if windowed and L < S:
        # ring alignment: the entry for absolute position p sits in slot
        # p % L
        shift = (S - L) % L
        kc, vc = torch.roll(kc, shift, dims=1), torch.roll(vc, shift, dims=1)
    return out, KVCache(k=kc.to(cfg.cdtype), v=vc.to(cfg.cdtype))


class KVCache(NamedTuple):
    k: torch.Tensor     # (..., B, L, KH, hd): L = seq_len, or window (ring)
    v: torch.Tensor


def _is_windowed(cfg: ModelConfig, layer_kind: str, long_mode: bool) -> bool:
    return (layer_kind == "attn_local" or cfg.attention == "sliding"
            or (long_mode and cfg.long_context == "sliding_window"))


def gqa_init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                   layer_kind: str = "attn", long_mode: bool = False,
                   lead: tuple = (), device) -> KVCache:
    """Zero caches of shape ``lead + (batch, L, KH, hd)`` in the compute
    dtype on ``device`` (``"meta"``: shapes only)."""
    windowed = _is_windowed(cfg, layer_kind, long_mode)
    L = min(cfg.window, seq_len) if windowed else seq_len
    shape = tuple(lead) + (batch, L, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.cdtype, device=device))


def gqa_decode(params, cache: KVCache, x, pos, cfg: ModelConfig, *,
               layer_kind: str = "attn", long_mode: bool = False):
    """One-token decode. x: (B,1,d); ``pos``: the current position, a
    Python int.  Writes the token's K/V into ``cache`` in place (windowed
    layers: slot ``pos % L`` of the ring) and returns (out (B,1,d),
    cache).  A ``pos`` past a linear cache raises, where the reference's
    update slice clamps it to the last slot."""
    pos = operator.index(pos)
    B = x.shape[0]
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KH
    L = cache.k.shape[1]
    windowed = _is_windowed(cfg, layer_kind, long_mode)
    if pos < 0 or (not windowed and pos >= L):
        raise IndexError(f"decode position {pos} outside the linear cache's "
                         f"{L} slots")
    q = linear(params["wq"], x).reshape(B, 1, H, hd)
    k = linear(params["wk"], x).reshape(B, 1, KH, hd)
    v = linear(params["wv"], x).reshape(B, 1, KH, hd)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k = _apply_positions(cfg, q, k, positions, layer_kind=layer_kind)

    slot = pos % L if windowed else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    idx = torch.arange(L, device=x.device)
    if windowed:
        # slot i holds absolute position pos - ((slot - i) mod L)
        age = torch.remainder(slot - idx, L)
        valid = ((pos - age) >= 0) & (age < cfg.window)
    else:
        valid = idx <= pos
    # one float32 copy of this layer's K (then V) at a time, (B,KH,L,hd)
    qg = q.reshape(B, KH, G, hd).to(torch.float32)
    kf = cache.k.transpose(1, 2).to(torch.float32,
                                    memory_format=torch.contiguous_format)
    s = (qg @ kf.transpose(-1, -2)) * hd ** -0.5              # (B,KH,G,L)
    del kf
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vf = cache.v.transpose(1, 2).to(torch.float32,
                                    memory_format=torch.contiguous_format)
    o = (p @ vf).reshape(B, 1, H * hd).to(x.dtype)            # (B,KH,G,hd)
    return linear(params["wo"], o), cache


def mla_forward(params, x, positions, cfg: ModelConfig, **_):
    raise NotImplementedError(
        "MLA attention (minicpm3) is not ported yet (ROADMAP queue 1 "
        "item 3b)")
