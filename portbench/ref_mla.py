"""Plain PyTorch reference of a dense decoder with multi-head latent
attention (MiniCPM3's family): low-rank query and KV projections, each
latent RMS-normed, a rope part of the query per head and one rope key
shared by all heads, the KV latent expanded through ``wkv_b`` into each
head's key and value.  Scores scale by ``(qk_nope + qk_rope) ** -0.5``.
Everything else (norms, MLP, embedding, head, loss, numerics) is
:mod:`portbench.ref_gqa`'s.
"""
from __future__ import annotations

import torch

from . import ref_gqa as base

# the widths at which the CPU tests drive this family (the configuration's
# keys they replace)
TINY = dict(d_model=16, n_heads=2, n_kv_heads=2, d_ff=16, vocab_size=32,
            mla=dict(q_lora_rank=8, kv_lora_rank=8, qk_nope_head_dim=4,
                     qk_rope_head_dim=4, v_head_dim=4, absorb=False))


def attention_layout(cfg):
    m = cfg["mla"]
    d, H = cfg["d_model"], cfg["n_heads"]
    qd = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return (base._linear("wq_a", d, m["q_lora_rank"])
            + base._norm("q_norm", m["q_lora_rank"])
            + base._linear("wq_b", m["q_lora_rank"], H * qd)
            + base._linear("wkv_a", d, m["kv_lora_rank"] + m["qk_rope_head_dim"])
            + base._norm("kv_norm", m["kv_lora_rank"])
            + base._linear("wkv_b", m["kv_lora_rank"],
                           H * (m["qk_nope_head_dim"] + m["v_head_dim"]))
            + base._linear("wo", H * m["v_head_dim"], d))


def attention(prec, p, x, cfg):
    m = cfg["mla"]
    B, S, _ = x.shape
    H = cfg["n_heads"]
    dn, dr, dv, rank = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"], m["kv_lora_rank"])
    q_lat = base.rmsnorm(base.linear(prec, base.sub(p, "wq_a"), x),
                         p[("q_norm", "scale")])
    kv_a = base.linear(prec, base.sub(p, "wkv_a"), x)
    c_kv = base.rmsnorm(kv_a[..., :rank], p[("kv_norm", "scale")])
    k_rope = kv_a[..., rank:].reshape(B, S, 1, dr)
    q = base.linear(prec, base.sub(p, "wq_b"), q_lat).reshape(B, S, H, dn + dr)
    cos, sin = base.rope_tables(torch.arange(S, device=x.device), dr,
                                cfg["rope_theta"])
    q_nope, q_rope = q[..., :dn], base.rotate(q[..., dn:], cos, sin)
    k_rope = base.rotate(k_rope, cos, sin)
    kv = base.linear(prec, base.sub(p, "wkv_b"), c_kv).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    # the one rope key is shared by the heads in float32
    q_all = torch.cat([q_nope, q_rope], dim=-1).float()
    k_all = torch.cat([k_nope.float(), k_rope.float().expand(B, S, H, dr)],
                      dim=-1)
    out = base.causal_attention(q_all, k_all, v.float(), (dn + dr) ** -0.5,
                                x.dtype)
    return base.linear(prec, base.sub(p, "wo"), out.to(x.dtype))


def layout(cfg):
    return base.layout(cfg, attention_layout)


def loss_and_grads(params, tokens, cfg, prec, rows_at_once=None):
    return base.loss_and_grads(params, tokens, cfg, prec, attention,
                               rows_at_once)
