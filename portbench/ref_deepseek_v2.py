"""Plain PyTorch reference of DeepSeek-V2-Lite's decoder (``modeling_deepseek.
py``'s ``DeepseekV2Attention``, ``DeepseekV2YarnRotaryEmbedding``,
``MoEGate`` and ``DeepseekV2MoE``), written from the published
description and independent of the program under test.

* Attention is MLA without a query latent: one ``wq`` (d -> H (dn + dr)),
  the KV latent through ``wkv_a``, RMS-normed, expanded by ``wkv_b`` into
  each head's key and value, one rope key shared by the heads.  Rope is
  YaRN over the ``dr`` rope dims; the scores scale by ``(dn + dr) ** -0.5
  * m ** 2``, ``m = 0.1 * mscale_all_dim * ln(factor) + 1``.
* The first ``first_k_dense_replace`` layers have the dense MLP; the
  others are MoE: a float32 softmax router over ``n_router`` experts, the
  greedy top-k (ties to the lower id), the raw probabilities as weights
  (``norm_topk_prob`` false, ``routed_scaling_factor`` 1), and a shared
  MLP of ``n_shared * d_expert`` on every token.
* The loss is the mean next-token cross entropy plus ``router_aux_weight``
  times the sum over the MoE layers of the sequence-wise balance loss.

This chip holds ``n_experts`` of the router's experts, ``[first_expert,
first_expert + n_experts)``: each is computed on every token and weighted
by a mask of the pairs routed to it (zero elsewhere); what the experts
held elsewhere would add is left out, as in the program.

Departures from the published model, as the program runs it: the rope
rotates interleaved pairs of the rope dims where HF permutes them into
halves first (the same permutation of q and k, so the scores are equal);
YaRN's frequencies are worked out in float64 and rounded to float32, HF's
in float32; cos and sin are not scaled (``mscale / mscale_all_dim`` is 1).
Numerics otherwise follow :mod:`portbench.ref_gqa` (bf16 products against
weights cast at use, float32 norms, softmax, scores and router, float32
sums of the experts' weighted outputs).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import ref_gqa as base

# the widths at which the CPU tests drive this family (the configuration's
# keys they replace): a dense layer and two MoE layers holding experts
# 4..7 of 16, with shared experts
TINY = dict(n_layers=3, first_k_dense_replace=1, d_model=16, n_heads=2,
            n_kv_heads=2, d_ff=24, vocab_size=32,
            mla=dict(q_lora_rank=None, kv_lora_rank=8, qk_nope_head_dim=4,
                     qk_rope_head_dim=8, v_head_dim=4, absorb=False),
            moe=dict(n_experts=4, top_k=3, d_expert=8, impl="dropless",
                     router_aux_weight=0.001, n_router=16, first_expert=4,
                     n_shared=2, norm_topk=False, balance="sequence"))


# ---------------------------------------------------------------- layout --

def attention_layout(cfg):
    m = cfg["mla"]
    d, H = cfg["d_model"], cfg["n_heads"]
    qd = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return (base._linear("wq", d, H * qd)
            + base._linear("wkv_a", d, m["kv_lora_rank"] + m["qk_rope_head_dim"])
            + base._norm("kv_norm", m["kv_lora_rank"])
            + base._linear("wkv_b", m["kv_lora_rank"],
                           H * (m["qk_nope_head_dim"] + m["v_head_dim"]))
            + base._linear("wo", H * m["v_head_dim"], d))


def _block(cfg, ffn):
    d = cfg["d_model"]
    return (base._norm("norm1", d)
            + [(("attn",) + p, s, i) for p, s, i in attention_layout(cfg)]
            + base._norm("norm2", d) + ffn)


def _mlp(prefix, d, f):
    return [(prefix + p, s, i) for p, s, i in
            base._linear("gate", d, f) + base._linear("up", d, f)
            + base._linear("down", f, d)]


def _moe(cfg):
    e, d = cfg["moe"], cfg["d_model"]
    E, f = e["n_experts"], e["d_expert"]
    return ([(("moe", "router", "w"), (d, e["n_router"]), "matrix"),
             (("moe", "gate"), (E, d, f), "matrix"),
             (("moe", "up"), (E, d, f), "matrix"),
             (("moe", "down"), (E, f, d), "matrix")]
            + _mlp(("moe", "shared"), d, e["n_shared"] * f))


def layout(cfg):
    """[(path, shape, init)] of every parameter leaf, sorted by path: the
    leading dense layers unstacked under ``dense.l{i}``, the MoE layers
    stacked on a leading dim under ``units.b0``."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    n_dense = cfg["first_k_dense_replace"]
    L = cfg["n_layers"] - n_dense
    out = [(("embed", "table"), (V, d), "embedding"),
           (("final_norm", "scale"), (d,), "ones"),
           (("lm_head", "w"), (d, V), "matrix")]
    dense = _block(cfg, _mlp(("mlp",), d, cfg["d_ff"]))
    for i in range(n_dense):
        out += [(("dense", f"l{i}") + p, s, init) for p, s, init in dense]
    out += [(("units", "b0") + p, (L,) + s, init)
            for p, s, init in _block(cfg, _moe(cfg))]
    return sorted(out)


# ------------------------------------------------------------------ rope --

def yarn_mscale(factor, mscale):
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_tables(positions, dim: int, theta: float, rs: dict):
    """YaRN's cos and sin (S, dim), each frequency repeated for its pair
    of interleaved dims: the base frequency ``theta ** (-2i / dim)``
    divided by ``factor`` where pair ``i`` turns fewer than ``beta_slow``
    times over the original context, kept where it turns more than
    ``beta_fast`` times, blended linearly in ``i`` between (float64,
    rounded to float32)."""
    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi)) / (2 * math.log(theta)))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    i = np.arange(dim // 2, dtype=np.float64)
    ramp = np.clip((i - low) / max(high - low, 1e-3), 0.0, 1.0)
    extra = theta ** (-2.0 * i / dim)
    inv = extra * (1.0 - ramp) + extra / rs["factor"] * ramp
    ang = positions.float()[:, None] * torch.from_numpy(
        inv.astype(np.float32)).to(positions.device)
    return (torch.repeat_interleave(torch.cos(ang), 2, dim=-1),
            torch.repeat_interleave(torch.sin(ang), 2, dim=-1))


# -------------------------------------------------------------- forward --

def attention(prec, p, x, cfg):
    m, rs = cfg["mla"], cfg["rope_scaling"]
    B, S, _ = x.shape
    H = cfg["n_heads"]
    dn, dr, dv, rank = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"], m["kv_lora_rank"])
    q = base.linear(prec, base.sub(p, "wq"), x).reshape(B, S, H, dn + dr)
    kv_a = base.linear(prec, base.sub(p, "wkv_a"), x)
    c_kv = base.rmsnorm(kv_a[..., :rank], p[("kv_norm", "scale")])
    k_rope = kv_a[..., rank:].reshape(B, S, 1, dr)
    cos, sin = yarn_tables(torch.arange(S, device=x.device), dr,
                           cfg["rope_theta"], rs)
    q_nope, q_rope = q[..., :dn], base.rotate(q[..., dn:], cos, sin)
    k_rope = base.rotate(k_rope, cos, sin)
    kv = base.linear(prec, base.sub(p, "wkv_b"), c_kv).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_all = torch.cat([q_nope, q_rope], dim=-1).float()
    k_all = torch.cat([k_nope.float(), k_rope.float().expand(B, S, H, dr)],
                      dim=-1)
    ms = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    out = base.causal_attention(q_all, k_all, v.float(),
                                (dn + dr) ** -0.5 * ms * ms, x.dtype)
    return base.linear(prec, base.sub(p, "wo"), out.to(x.dtype))


def ffn(prec, p, x):
    """The gated MLP of ``p``'s ``gate``, ``up`` and ``down`` weights."""
    return base.linear(prec, {"w": p["down"]},
                       F.silu(base.linear(prec, {"w": p["gate"]}, x))
                       * base.linear(prec, {"w": p["up"]}, x))


def moe(prec, p, x, cfg):
    """(the MoE layer's output (B, S, d), its sequence balance loss)."""
    e = cfg["moe"]
    B, S, d = x.shape
    K, R, e0 = e["top_k"], e["n_router"], e["first_expert"]
    # the layer reads its input in float32 (the router's precision): the
    # input's gradient adds its uses in float32
    xf = x.reshape(B * S, d).float()
    probs = torch.softmax(xf @ p[("router", "w")].float(), dim=-1)
    # the greedy top-k, ties to the lower id
    ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
    weight = probs.gather(1, ids)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for j in range(e["n_experts"]):
        w_j = (weight * (ids == e0 + j)).sum(dim=1)
        y = ffn(prec, {k: p[(k,)][j] for k in ("gate", "up", "down")},
                xf.to(x.dtype))
        out = out + w_j[:, None] * y.float()
    shared = ffn(prec, {k: p[("shared", k, "w")] for k in ("gate", "up", "down")},
                 xf.to(x.dtype))
    # the sequence loss over all the router's experts
    chosen = F.one_hot(ids, R).sum(dim=1).reshape(B, S, R)
    f = chosen.sum(dim=1).float() * R / (K * S)
    balance = (f * probs.reshape(B, S, R).mean(dim=1)).sum(dim=1).mean()
    return (out.to(x.dtype) + shared).reshape(B, S, d), balance


def _sub(params, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k[:n] == prefix}


def loss(params, tokens, cfg, prec):
    """Mean next-token cross entropy plus the weighted balance losses."""
    cdt = getattr(torch, cfg["compute_dtype"])
    h = F.embedding(tokens.long(), params[("embed", "table")]).to(cdt)
    for i in range(cfg["first_k_dense_replace"]):
        lp = _sub(params, ("dense", f"l{i}"))
        h = h + attention(prec, _sub(lp, ("attn",)),
                          base.rmsnorm(h, lp[("norm1", "scale")]), cfg)
        h = h + ffn(prec, {k: lp[("mlp", k, "w")] for k in ("gate", "up", "down")},
                    base.rmsnorm(h, lp[("norm2", "scale")]))
    balance = torch.zeros((), device=tokens.device)
    for i in range(cfg["n_layers"] - cfg["first_k_dense_replace"]):
        lp = base.layer_params(params, i)
        h = h + attention(prec, _sub(lp, ("attn",)),
                          base.rmsnorm(h, lp[("norm1", "scale")]), cfg)
        out, b = moe(prec, _sub(lp, ("moe",)),
                     base.rmsnorm(h, lp[("norm2", "scale")]), cfg)
        h = h + out
        balance = balance + b
    h = base.rmsnorm(h, params[("final_norm", "scale")])
    logits = base.linear(prec, {"w": params[("lm_head", "w")]}, h).float()[:, :-1]
    tgt = tokens[:, 1:].long()
    nll = (torch.logsumexp(logits, dim=-1)
           - logits.gather(-1, tgt[..., None])[..., 0]).mean()
    return nll + cfg["moe"]["router_aux_weight"] * balance


def loss_and_grads(params, tokens, cfg, prec, rows_at_once=None):
    """(mean loss, {path: float32 gradient}) over the rows of ``tokens``,
    ``rows_at_once`` rows a pass (all by default), each pass weighted by
    its share of the rows: both terms of the loss are means over the
    sequences."""
    B = tokens.shape[0]
    n = rows_at_once or B
    paths = sorted(params)
    leaves = [params[p].detach().requires_grad_() for p in paths]
    live = dict(zip(paths, leaves))
    total, grads = 0.0, None
    for start in range(0, B, n):
        part = tokens[start:start + n]
        w = part.shape[0] / B
        value = loss(live, part, cfg, prec)
        gs = torch.autograd.grad(value * w, leaves)
        total += float(value.detach()) * w
        grads = list(gs) if grads is None else [a + b for a, b in zip(grads, gs)]
    return total, dict(zip(paths, grads))
