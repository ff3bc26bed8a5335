"""Mixture-of-Experts FFN: top-k router + two dispatch implementations
(PyTorch port of ``repro.models.moe``).

* ``dense``    -- every expert runs on every token, combined by router
                  weight.  Exact (no token dropping); the reduced configs'
                  path and the oracle of the capacity path.
* ``capacity`` -- sort-based dispatch into a static (E, C, D) buffer
                  (C = top_k * T / E * capacity_factor); the per-expert
                  GEMMs are batched matmuls; the pairs past an expert's
                  capacity are dropped.  The published configs' path.

Router aux losses: load-balance (Switch) + z-loss, returned for logging
and added to the training objective.

The reference's matmuls, sort, searchsorted and gathers are XLA library
ops; here they are torch's.  Two orders are pinned to the reference's:
the router's top-k breaks ties to the lowest expert (``lax.top_k``), and
the capacity path's combine adds each token's contributions one at a
time from zero in the compute dtype, in the order of the sorted pairs
(the reference's ``.at[t_s].add`` in bf16), never with atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sparsify import topk_indices

from .config import ModelConfig
from .layers import Init


def moe_init(init: Init, cfg: ModelConfig):
    e, d = cfg.moe, cfg.d_model
    p = {
        "router": {"w": init.normal((d, e.n_experts), d ** -0.5,
                                    cfg.pdtype)},
        "up": init.normal((e.n_experts, d, e.d_expert), d ** -0.5,
                          cfg.pdtype),
        "down": init.normal((e.n_experts, e.d_expert, d),
                            e.d_expert ** -0.5, cfg.pdtype),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["gate"] = init.normal((e.n_experts, d, e.d_expert), d ** -0.5,
                                cfg.pdtype)
    return p


def _act(cfg: ModelConfig, x):
    # jax.nn.gelu is the tanh approximation by default
    if cfg.activation in ("swiglu", "silu"):
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def _expert_ffn(p, h, cfg: ModelConfig):
    """h: (E, C, D) -> (E, C, D): each expert's gated MLP on its rows, the
    weights cast to h's dtype at use."""
    dt = h.dtype
    up = torch.matmul(h, p["up"].to(dt))
    if "gate" in p:
        z = _act(cfg, torch.matmul(h, p["gate"].to(dt))) * up
    else:
        z = _act(cfg, up)
    return torch.matmul(z, p["down"].to(dt))


def router_probs(p, x, cfg: ModelConfig):
    """x: (T, D) -> (probs (T, K), ids (T, K), aux losses dict)."""
    e = cfg.moe
    logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs_full = torch.softmax(logits, dim=-1)
    ids = topk_indices(probs_full, e.top_k)        # ties to the lowest id
    top_p = torch.gather(probs_full, -1, ids)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)  # renormalise
    # Switch load-balance loss + router z-loss
    density = torch.mean(
        F.one_hot(ids[:, 0], e.n_experts).to(torch.float32), dim=0)
    mean_prob = torch.mean(probs_full, dim=0)
    lb = e.n_experts * torch.sum(density * mean_prob)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, ids, {"load_balance": lb, "router_z": z}


def moe_forward_dense(p, x, cfg: ModelConfig, *, experts=None):
    """Exact dense-dispatch MoE. x: (B, S, D).  ``experts(h)`` maps (E, T,
    D) to the experts' outputs (default: ``p``'s experts on one device;
    under expert parallelism, the shards' experts gathered)."""
    experts = experts or (lambda h: _expert_ffn(p, h, cfg))
    e = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    top_p, ids, aux = router_probs(p, xf, cfg)
    # every expert on every token: (E, T, D)
    out_all = experts(xf[None].expand(e.n_experts, T, D))
    rows = torch.arange(T, device=x.device)[:, None].expand_as(ids)
    w = torch.zeros((T, e.n_experts), dtype=torch.float32,
                    device=x.device).index_put_((rows, ids), top_p,
                                                accumulate=True)
    out = torch.einsum("te,etd->td", w.to(out_all.dtype), out_all)
    return out.reshape(B, S, D).to(x.dtype), aux


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens: Python's ``round`` (half
    to even), at least 1."""
    e = cfg.moe
    return max(1, int(round(n_tokens * e.top_k / e.n_experts
                            * e.capacity_factor)))


def dispatch(ids, cfg: ModelConfig):
    """The capacity path's routing of the (token, choice) pairs, from the
    router's ids (T, K).  Returns (order, e_s, t_s, keep, slot): the stable
    sort of the flat pairs by expert, their experts and tokens in that
    order, whether each pair fits its expert's C slots, and its slot
    (``E * C`` when dropped)."""
    T, K = ids.shape
    E = cfg.moe.n_experts
    C = capacity(T, cfg)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    t_s = order // K                     # the pair's token: flat_t[order]
    pos = torch.arange(T * K, device=ids.device) - torch.searchsorted(
        e_s, e_s, right=False)           # rank within its expert
    keep = pos < C
    slot = torch.where(keep, e_s * C + pos, E * C)
    return order, e_s, t_s, keep, slot


def combine(contrib, order, n_tokens: int):
    """``zeros((T, D)).at[t_s].add(contrib)`` in ``contrib``'s dtype, with
    ``contrib`` (T*K, D) in the sorted pairs' order: each token's K
    contributions gathered in that order (the inverse of the stable sort
    gives each pair's place) and added one at a time from zero, as the
    reference's serial scatter adds them.  No atomics: the same bits run
    to run on the card."""
    TK, D = contrib.shape
    K = TK // n_tokens
    place = torch.empty_like(order)
    place[order] = torch.arange(TK, dtype=order.dtype, device=order.device)
    place = torch.sort(place.reshape(n_tokens, K), dim=1).values
    out = torch.zeros((n_tokens, D), dtype=contrib.dtype,
                      device=contrib.device)
    for k in range(K):
        out = out + contrib[place[:, k]]
    return out


def moe_forward_capacity(p, x, cfg: ModelConfig, *, experts=None):
    """Sort-based static-capacity MoE. x: (B, S, D); ``experts`` as in
    :func:`moe_forward_dense`, on the (E, C, D) slots."""
    experts = experts or (lambda h: _expert_ffn(p, h, cfg))
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    top_p, ids, aux = router_probs(p, xf, cfg)
    E, C = e.n_experts, capacity(T, cfg)
    order, _, t_s, keep, slot = dispatch(ids, cfg)
    p_s = top_p.reshape(-1)[order]
    # dispatch by a small token table and a gather: the empty slots read
    # the pad row T; the dropped pairs all land on slot E*C, cut off
    tok_table = torch.full((E * C + 1,), T, dtype=torch.int64,
                           device=x.device)
    tok_table[slot] = t_s
    xpad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    buf = xpad[tok_table[:E * C]]
    out_buf = experts(buf.reshape(E, C, D)).reshape(E * C, D)
    # combine back: gather slot outputs, weight, sum over the K choices
    contrib = torch.where(keep[:, None],
                          out_buf[torch.clamp(slot, max=E * C - 1)], 0.0) \
        * p_s[:, None].to(out_buf.dtype)
    out = combine(contrib, order, T)
    return out.reshape(B, S, D).to(x.dtype), aux


def moe_forward(p, x, cfg: ModelConfig, *, experts=None):
    if cfg.moe.impl == "dense":
        return moe_forward_dense(p, x, cfg, experts=experts)
    return moe_forward_capacity(p, x, cfg, experts=experts)
