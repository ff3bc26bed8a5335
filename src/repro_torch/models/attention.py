"""Attention blocks: GQA with full, sliding-window and local:global masks,
MLA (multi-head latent attention), and their caches (PyTorch port of
``repro.models.attention``).

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

MLA (MiniCPM3/DeepSeek-style) caches the compressed latent ``c_kv`` and
the one shared rope key only, linear over ``seq_len`` in every mode.  Its
decode either expands the whole cache through ``wkv_b`` (``absorb=False``)
or folds ``wkv_b`` into the query and the output (``absorb=True``).
"""
from __future__ import annotations

import operator
from typing import NamedTuple

import torch

from . import rope as rope_lib
from .config import ModelConfig
from .layers import Init, linear, linear_init, norm_init, rmsnorm
from .multimodal import mrope_text_position

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
        if positions.dim() == 2:    # (B,S) text only -> three equal streams
            positions = rope_lib.text_mrope_positions(positions)
        return rope_lib.mrope(q, k, positions, theta=theta,
                              sections=_mrope_sections(cfg))
    rd = int(cfg.hd * cfg.rotary_pct)
    rd -= rd % 2
    return rope_lib.standard_rope(q, k, positions, theta=theta,
                                  rotary_dim=rd)


def _mrope_sections(cfg: ModelConfig):
    """M-RoPE's (t, h, w) pairs, summing to hd/2 in a 1:1.5:1.5 split
    (qwen2-vl's (16, 24, 24) at hd 128)."""
    half = cfg.hd // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def gqa_forward(params, x, positions, cfg: ModelConfig, *,
                layer_kind: str = "attn", chunk_q: int = 512,
                return_kv: bool = False):
    """Training/prefill GQA attention. x: (B,S,d) -> (B,S,d) (and the
    layer's :class:`KVCache` when ``return_kv``)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(params["wq"], x).reshape(B, S, H, hd)
    k = linear(params["wk"], x).reshape(B, S, KH, hd)
    v = linear(params["wv"], x).reshape(B, S, KH, hd)
    q, k = _apply_positions(cfg, q, k, positions, layer_kind=layer_kind)
    out = gqa_attend(q, k, v, cfg, layer_kind=layer_kind, chunk_q=chunk_q)
    out = linear(params["wo"], out.to(x.dtype))
    if not return_kv:
        return out
    return out, gqa_cache_of(k, v, cfg, layer_kind=layer_kind)


def gqa_attend(q, k, v, cfg: ModelConfig, *, layer_kind: str = "attn",
               chunk_q: int = 512):
    """Chunked attention of rotated queries (B,S,H,hd) over K/V
    (B,S,KH,hd), any H a multiple of KH (a model shard's heads): the heads'
    outputs (B,S,H*hd) float32."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    windowed = layer_kind == "attn_local" or cfg.attention == "sliding"
    window = cfg.window if windowed else None

    C = min(chunk_q, S)
    while S % C:
        C -= 1
    scale = hd ** -0.5
    kt = k.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]   # (B,KH,1,hd,S)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]   # (B,KH,1,S,hd)
    qg = q.reshape(B, S, KH, G, hd).permute(0, 2, 3, 1, 4)    # (B,KH,G,S,hd)
    kv_pos = torch.arange(S, device=q.device)
    outs = []
    for start_q in range(0, S, C):
        q_pos = start_q + torch.arange(C, device=q.device)
        ks, vs, kp = kt, vf, kv_pos
        if window is not None and window + C < S:
            # slice K/V to [chunk_start - window, chunk_start + C)
            kw = window + C
            start = min(max(start_q - window, 0), S - kw)
            ks = kt[..., start:start + kw]
            vs = vf[..., start:start + kw, :]
            kp = start + torch.arange(kw, device=q.device)
        mask = kp[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kp[None, :] > q_pos[:, None] - window
        s = (qg[:, :, :, start_q:start_q + C].to(torch.float32) @ ks) * scale
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        # the reference rounds p to the compute dtype before the PV matmul
        outs.append(p.to(v.dtype).to(torch.float32) @ vs)  # (B,KH,G,C,hd)
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


def gqa_cache_of(k, v, cfg: ModelConfig, *, layer_kind: str = "attn"):
    """The layer's :class:`KVCache` from its rotated K and V (B,S,KH,hd):
    the last ``window`` positions of a windowed layer, ring-aligned."""
    S = k.shape[1]
    windowed = layer_kind == "attn_local" or cfg.attention == "sliding"
    L = min(cfg.window, S) if windowed else S
    kc, vc = k[:, S - L:], v[:, S - L:]
    if windowed and L < S:
        # ring alignment: the entry for absolute position p sits in slot
        # p % L
        shift = (S - L) % L
        kc, vc = torch.roll(kc, shift, dims=1), torch.roll(vc, shift, dims=1)
    return KVCache(k=kc.to(cfg.cdtype), v=vc.to(cfg.cdtype))


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
    update slice clamps it to the last slot.  Under M-RoPE the rotation
    takes the text position ``multimodal.mrope_text_position(cfg, pos)``;
    the slot and the mask keep ``pos``."""
    pos = operator.index(pos)
    B = x.shape[0]
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = cache.k.shape[1]
    windowed = _is_windowed(cfg, layer_kind, long_mode)
    if pos < 0 or (not windowed and pos >= L):
        raise IndexError(f"decode position {pos} outside the linear cache's "
                         f"{L} slots")
    q = linear(params["wq"], x).reshape(B, 1, H, hd)
    k = linear(params["wk"], x).reshape(B, 1, KH, hd)
    v = linear(params["wv"], x).reshape(B, 1, KH, hd)
    q, k = gqa_decode_positions(cfg, q, k, pos, layer_kind=layer_kind)
    o = gqa_decode_attend(q, k, v, cache, pos, cfg, layer_kind=layer_kind,
                          long_mode=long_mode)
    return linear(params["wo"], o.to(x.dtype)), cache


def gqa_decode_positions(cfg: ModelConfig, q, k, pos: int, *,
                         layer_kind: str):
    """Decode's rotation of the one token's q (B,1,H,hd) and k."""
    B = q.shape[0]
    rpos = mrope_text_position(cfg, pos) if cfg.rope == "mrope" else pos
    positions = torch.full((B, 1), rpos, dtype=torch.int32, device=q.device)
    return _apply_positions(cfg, q, k, positions, layer_kind=layer_kind)


def gqa_decode_attend(q, k, v, cache: KVCache, pos: int, cfg: ModelConfig,
                      *, layer_kind: str = "attn", long_mode: bool = False):
    """Write the token's rotated k and v (B,1,KH,hd) into ``cache`` and
    attend its queries (B,1,H,hd), any H a multiple of KH: (B,1,H*hd) in
    float32."""
    B, _, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    L = cache.k.shape[1]
    windowed = _is_windowed(cfg, layer_kind, long_mode)
    slot = pos % L if windowed else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    idx = torch.arange(L, device=q.device)
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
    return (p @ vf).reshape(B, 1, H * hd)                     # (B,KH,G,hd)


# ---------------------------------------------------------------- MLA --

def mla_init(init: Init, cfg: ModelConfig):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": linear_init(init, d, m.q_lora_rank, dtype=cfg.pdtype),
        "q_norm": norm_init(init, "rmsnorm", m.q_lora_rank, dtype=cfg.pdtype),
        "wq_b": linear_init(init, m.q_lora_rank, H * qd, dtype=cfg.pdtype),
        "wkv_a": linear_init(init, d, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype=cfg.pdtype),
        "kv_norm": norm_init(init, "rmsnorm", m.kv_lora_rank,
                             dtype=cfg.pdtype),
        "wkv_b": linear_init(init, m.kv_lora_rank,
                             H * (m.qk_nope_head_dim + m.v_head_dim),
                             dtype=cfg.pdtype),
        "wo": linear_init(init, H * m.v_head_dim, d, dtype=cfg.pdtype),
    }


def _mla_qkv(params, x, positions, cfg: ModelConfig):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,rank), k_rope
    (B,S,1,dr)); RoPE at the full ``dr`` on the queries and on the one
    shared key."""
    q_lat, c_kv, k_rope = mla_latents(params, x, cfg)
    q_nope, q_rope, k_rope = mla_heads(params, q_lat, k_rope, positions, cfg)
    return q_nope, q_rope, c_kv, k_rope


def mla_latents(params, x, cfg: ModelConfig):
    """The head-independent part of MLA: (the normed query latent
    (B,S,q_rank), the normed KV latent c_kv (B,S,rank), the unrotated rope
    key (B,S,1,dr))."""
    m = cfg.mla
    B, S, _ = x.shape
    q_lat = rmsnorm(params["q_norm"], linear(params["wq_a"], x))
    kv_a = linear(params["wkv_a"], x)
    c_kv = rmsnorm(params["kv_norm"], kv_a[..., :m.kv_lora_rank])
    k_rope = kv_a[..., m.kv_lora_rank:].reshape(B, S, 1, m.qk_rope_head_dim)
    return q_lat, c_kv, k_rope


def mla_heads(params, q_lat, k_rope, positions, cfg: ModelConfig):
    """The heads of ``params["wq_b"]`` (all, or a model shard's) from the
    query latent: (q_nope, q_rope, k_rope), the two rope parts rotated."""
    m = cfg.mla
    B, S, _ = q_lat.shape
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = linear(params["wq_b"], q_lat)
    q = q.reshape(B, S, q.shape[-1] // (dn + dr), dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope, k_rope = rope_lib.standard_rope(q_rope, k_rope, positions,
                                            theta=cfg.rope_theta)
    return q_nope, q_rope, k_rope


def _mla_expand_kv(params, c_kv, cfg: ModelConfig):
    """The latents through ``wkv_b`` (all heads, or a model shard's):
    (k_nope (..., H, dn), v (..., H, dv)) in the latents' dtype."""
    m = cfg.mla
    kv = linear(params["wkv_b"], c_kv)
    dh = m.qk_nope_head_dim + m.v_head_dim
    kv = kv.reshape(*c_kv.shape[:-1], kv.shape[-1] // dh, dh)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def mla_forward(params, x, positions, cfg: ModelConfig, *,
                chunk_q: int = 512, return_kv: bool = False, **_):
    """Training/prefill MLA, query-block chunked. x: (B,S,d) -> (B,S,d)
    (and the layer's :class:`MLACache` when ``return_kv``).  Scores scale
    by ``(dn + dr) ** -0.5``."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg)
    k_nope, v = _mla_expand_kv(params, c_kv, cfg)   # (B,S,H,dn), (B,S,H,dv)
    out = mla_attend(q_nope, q_rope, k_nope, k_rope, v, cfg, chunk_q=chunk_q)
    out = linear(params["wo"], out.to(x.dtype))
    if not return_kv:
        return out
    return out, MLACache(c_kv=c_kv.to(cfg.cdtype),
                         k_rope=k_rope[:, :, 0].to(cfg.cdtype))


def mla_attend(q_nope, q_rope, k_nope, k_rope, v, cfg: ModelConfig, *,
               chunk_q: int = 512):
    """Chunked causal MLA attention of H heads (all, or a model shard's):
    (B,S,H*dv) float32."""
    B, S, H, dn = q_nope.shape
    m = cfg.mla
    dr, dv = m.qk_rope_head_dim, m.v_head_dim
    scale = (dn + dr) ** -0.5
    C = min(chunk_q, S)
    while S % C:
        C -= 1
    knt = k_nope.to(torch.float32).permute(0, 2, 3, 1)       # (B,H,dn,S)
    krt = k_rope.to(torch.float32).permute(0, 2, 3, 1)       # (B,1,dr,S)
    vf = v.to(torch.float32).transpose(1, 2)                 # (B,H,S,dv)
    qn = q_nope.to(torch.float32).transpose(1, 2)            # (B,H,S,dn)
    qr = q_rope.to(torch.float32).transpose(1, 2)            # (B,H,S,dr)
    kv_pos = torch.arange(S, device=q_nope.device)
    outs = []
    for start in range(0, S, C):
        q_pos = start + torch.arange(C, device=q_nope.device)
        s = (qn[:, :, start:start + C] @ knt
             + qr[:, :, start:start + C] @ krt) * scale      # (B,H,C,S)
        s = torch.where(kv_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        # the reference rounds p to the compute dtype before the PV matmul
        outs.append(p.to(v.dtype).to(torch.float32) @ vf)   # (B,H,C,dv)
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * dv)


class MLACache(NamedTuple):
    c_kv: torch.Tensor      # (..., B, L, kv_lora_rank)
    k_rope: torch.Tensor    # (..., B, L, rope_dim)


def mla_init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                   lead: tuple = (), device, **_) -> MLACache:
    """Zero latents of ``lead + (batch, seq_len, ...)`` in the compute
    dtype: linear in every mode (``long_mode`` keeps no ring)."""
    m = cfg.mla
    lead = tuple(lead) + (batch, seq_len)
    return MLACache(
        c_kv=torch.zeros(lead + (m.kv_lora_rank,), dtype=cfg.cdtype,
                         device=device),
        k_rope=torch.zeros(lead + (m.qk_rope_head_dim,), dtype=cfg.cdtype,
                           device=device))


def mla_decode(params, cache: MLACache, x, pos, cfg: ModelConfig, **_):
    """One-token MLA decode. x: (B,1,d); ``pos`` a Python int.  Writes
    the token's latent and rope key into ``cache`` in place and returns
    (out (B,1,d), cache).  Scores, softmax and the value product are
    float32, as the reference's einsums; a ``pos`` past the cache
    raises."""
    pos = operator.index(pos)
    B = x.shape[0]
    L = cache.c_kv.shape[1]
    if not 0 <= pos < L:
        raise IndexError(f"decode position {pos} outside the linear cache's "
                         f"{L} slots")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg)
    mla_cache_write(cache, c_kv, k_rope, pos)
    o = mla_decode_attend(params, cache, q_nope, q_rope, pos, cfg)
    return linear(params["wo"], o.to(x.dtype)), cache


def mla_cache_write(cache: MLACache, c_kv, k_rope, pos: int):
    """The token's latent (B,1,rank) and rotated rope key (B,1,1,dr) into
    slot ``pos``."""
    cache.c_kv[:, pos] = c_kv[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, pos] = k_rope[:, 0, 0].to(cache.k_rope.dtype)


def mla_decode_attend(params, cache: MLACache, q_nope, q_rope, pos: int,
                      cfg: ModelConfig):
    """The token's queries (B,1,H,dn|dr) of the heads of
    ``params["wkv_b"]`` (all, or a model shard's) against the cache:
    (B,1,H*dv) float32, absorbed or expanded as ``cfg.mla.absorb``."""
    B, _, H, dn = q_nope.shape
    m = cfg.mla
    dr, dv = m.qk_rope_head_dim, m.v_head_dim
    L = cache.c_kv.shape[1]
    valid = torch.arange(L, device=q_nope.device) <= pos
    scale = (dn + dr) ** -0.5
    qn = q_nope[:, 0].to(torch.float32)                      # (B,H,dn)
    qr = q_rope[:, 0].to(torch.float32)                      # (B,H,dr)
    s_rope = qr @ cache.k_rope.to(torch.float32).transpose(1, 2)  # (B,H,L)
    if m.absorb:
        # score = (q_nope @ Wkn^T) . c + q_rope . k_rope; out = (p . c) @ Wv
        wkv = params["wkv_b"]["w"].reshape(m.kv_lora_rank, H, dn + dv)
        wkn = wkv[..., :dn].to(torch.float32).permute(1, 2, 0)  # (H,dn,r)
        wv = wkv[..., dn:].to(torch.float32).transpose(0, 1)    # (H,r,dv)
        q_abs = (qn.transpose(0, 1) @ wkn).transpose(0, 1)      # (B,H,r)
        cf = cache.c_kv.to(torch.float32)                       # (B,L,r)
        s = (q_abs @ cf.transpose(1, 2) + s_rope) * scale
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = p @ cf                                            # (B,H,r)
        del cf
        o = (ctx.transpose(0, 1) @ wv).transpose(0, 1)          # (B,H,dv)
    else:
        k_nope, v = _mla_expand_kv(params, cache.c_kv, cfg)  # (B,L,H,dn|dv)
        kf = k_nope.permute(0, 2, 3, 1).to(
            torch.float32, memory_format=torch.contiguous_format)
        s = ((qn[:, :, None] @ kf)[:, :, 0] + s_rope) * scale   # (B,H,L)
        del kf, k_nope
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        vf = v.transpose(1, 2).to(torch.float32,
                                  memory_format=torch.contiguous_format)
        del v
        o = (p[:, :, None] @ vf)[:, :, 0]                       # (B,H,dv)
    return o.reshape(B, 1, H * dv)
