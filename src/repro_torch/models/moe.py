"""Mixture-of-Experts FFN: top-k router + three dispatch implementations
(PyTorch port of ``repro.models.moe``).

* ``dense``    -- every expert runs on every token, combined by router
                  weight.  Exact (no token dropping); the reduced configs'
                  path and the oracle of the other two.
* ``capacity`` -- sort-based dispatch into a static (E, C, D) buffer
                  (C = top_k * T / E * capacity_factor); the per-expert
                  GEMMs are batched matmuls; the pairs past an expert's
                  capacity are dropped.  The published configs' path.
* ``dropless`` -- the pairs sorted by expert and each expert's GEMMs run
                  on its own rows (``torch._grouped_mm`` with the group
                  ends on the device: no host sync, no pair dropped).
                  DeepSeek-V2's path.

A layer may hold only some of the router's experts (expert parallelism):
``[first_expert, first_expert + n_experts)`` of ``router_width``.  The
router scores all of them; the layer computes the part of the result its
own experts give and leaves the rest out.  Shared experts (one MLP of
``n_shared * d_expert``) run on every token and add to it.

Router aux losses: load-balance (Switch) + z-loss, or DeepSeek-V2's
sequence-wise balance loss alone, returned for logging and added to the
training objective.  The dropless path records the spans ``moe/route``,
``moe/dispatch``, ``moe/experts``, ``moe/shared`` and ``moe/combine``
(args lane and layer) and the device counters ``moe.pairs_held`` and
``moe.group_max`` on the recorder of the step that runs it
(``telemetry.trace.current``).

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
from repro_torch.telemetry import trace

from .config import ModelConfig
from .layers import Init, mlp, mlp_init


def moe_init(init: Init, cfg: ModelConfig):
    e, d = cfg.moe, cfg.d_model
    p = {
        "router": {"w": init.normal((d, e.router_width), d ** -0.5,
                                    cfg.pdtype)},
        "up": init.normal((e.n_experts, d, e.d_expert), d ** -0.5,
                          cfg.pdtype),
        "down": init.normal((e.n_experts, e.d_expert, d),
                            e.d_expert ** -0.5, cfg.pdtype),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["gate"] = init.normal((e.n_experts, d, e.d_expert), d ** -0.5,
                                cfg.pdtype)
    if e.n_shared:
        p["shared"] = mlp_init(init, d, e.n_shared * e.d_expert,
                               activation=cfg.activation, dtype=cfg.pdtype)
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


def router_probs(p, x, cfg: ModelConfig, *, seq_len: int | None = None):
    """x: (T, D) -> (probs (T, K), ids (T, K) over the router's experts,
    aux losses dict).  The sequence-wise balance loss takes the tokens as
    sequences of ``seq_len``."""
    e = cfg.moe
    R = e.router_width
    logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs_full = torch.softmax(logits, dim=-1)
    ids = topk_indices(probs_full, e.top_k)        # ties to the lowest id
    top_p = torch.gather(probs_full, -1, ids)
    if e.norm_topk:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    if e.balance == "sequence":
        return top_p, ids, {"load_balance": sequence_balance(
            probs_full, ids, R, seq_len or x.shape[0]),
            "router_z": torch.zeros((), device=x.device)}
    # Switch load-balance loss + router z-loss
    density = torch.mean(F.one_hot(ids[:, 0], R).to(torch.float32), dim=0)
    mean_prob = torch.mean(probs_full, dim=0)
    lb = R * torch.sum(density * mean_prob)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, ids, {"load_balance": lb, "router_z": z}


def sequence_balance(probs, ids, n_router: int, seq_len: int):
    """DeepSeek-V2's sequence-wise balance loss (without its factor):
    per sequence ``sum_i f_i P_i`` with ``f_i = R / (K S) * #{t: i in
    topK(t)}`` and ``P_i`` the mean of the token's router probability of
    ``i``, averaged over the sequences.  probs (T, R) float32, ids (T,
    K)."""
    T, K = ids.shape
    B = T // seq_len
    counts = F.one_hot(ids.reshape(B, seq_len * K), n_router).sum(dim=1)
    f = counts.to(torch.float32) / (seq_len * K / n_router)
    P = probs.reshape(B, seq_len, n_router).mean(dim=1)
    return (f * P).sum(dim=1).mean()


def _held_weights(top_p, ids, cfg: ModelConfig):
    """(ids local to the held experts, clamped into range; the weights
    with a pair routed elsewhere at 0; whether each pair is held)."""
    e = cfg.moe
    local = ids - e.first_expert
    held = (local >= 0) & (local < e.n_experts)
    return (local.clamp(0, e.n_experts - 1), torch.where(held, top_p, 0.0),
            held)


def moe_forward_dense(p, x, cfg: ModelConfig, *, experts=None):
    """Exact dense-dispatch MoE. x: (B, S, D).  ``experts(h)`` maps (E, T,
    D) to the experts' outputs (default: ``p``'s experts on one device;
    under expert parallelism, the shards' experts gathered)."""
    experts = experts or (lambda h: _expert_ffn(p, h, cfg))
    e = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    top_p, ids, aux = router_probs(p, xf, cfg, seq_len=S)
    # every expert on every token: (E, T, D)
    out_all = experts(xf[None].expand(e.n_experts, T, D))
    rows = torch.arange(T, device=x.device)[:, None].expand_as(ids)
    if e.router_width != e.n_experts:
        # the pairs routed to experts held elsewhere weigh nothing here
        ids, top_p, _ = _held_weights(top_p, ids, cfg)
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
    top_p, ids, aux = router_probs(p, xf, cfg, seq_len=S)
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


def group_ends(key_sorted, n_groups: int):
    """The end of each group ``0 .. n_groups - 1`` in the sorted keys, as
    ``torch._grouped_mm``'s int32 offsets (on the keys' device)."""
    bounds = torch.arange(1, n_groups + 1, dtype=key_sorted.dtype,
                          device=key_sorted.device)
    return torch.searchsorted(key_sorted, bounds).to(torch.int32)


def _grouped_ffn(p, h, ends, cfg: ModelConfig):
    """h: (N, D) pairs sorted by held expert, expert e's rows ending at
    ``ends[e]`` -> (N, D): each expert's gated MLP on its rows, the
    weights cast to h's dtype at use.  Rows past the last end are not
    computed: the caller masks them out."""
    dt = h.dtype
    up = torch._grouped_mm(h, p["up"].to(dt), offs=ends)
    if "gate" in p:
        z = _act(cfg, torch._grouped_mm(h, p["gate"].to(dt), offs=ends)) * up
    else:
        z = _act(cfg, up)
    return torch._grouped_mm(z, p["down"].to(dt), offs=ends)


def moe_forward_dropless(p, x32, cfg: ModelConfig, dtype, *,
                         layer: int = 0):
    """Dropless MoE over the held experts of x32 (B, S, D), the float32
    copy of the input, the experts computing in ``dtype``.  The (token,
    choice) pairs are sorted by held expert (the others after them, as
    one more group), each held expert's GEMMs run on its rows alone, and
    each token's weighted contributions are added in float32 in the order
    of its choices, from zero, then rounded to ``dtype``: no atomics, the
    same bits run to run.  The pairs are the tokens' rows repeated K
    times, so a token's gradient adds its pairs' in one float32 sum."""
    e = cfg.moe
    B, S, D = x32.shape
    T, K, E = B * S, e.top_k, e.n_experts
    xf = x32.reshape(T, D)
    rec, args = trace.current()
    args = dict(args, layer=layer)
    with rec.span("moe/route", **args):
        top_p, ids, aux = router_probs(p, xf, cfg, seq_len=S)
    with rec.span("moe/dispatch", **args):
        local, w, held = _held_weights(top_p, ids, cfg)
        key = torch.where(held, local, E).reshape(-1)
        order = torch.argsort(key, stable=True)
        key_s = key[order]
        ends = group_ends(key_s, E)
        held_s = (key_s < E)[:, None]
        pairs = xf[:, None].expand(T, K, D).reshape(T * K, D)
        h = torch.where(held_s, pairs[order].to(dtype), 0.0)
    with rec.span("moe/experts", **args):
        y = _grouped_ffn(p, h, ends, cfg)
    with rec.span("moe/combine", **args):
        contrib = torch.where(held_s, y.to(torch.float32)
                              * w.reshape(-1)[order][:, None], 0.0)
        place = torch.empty_like(order)
        place[order] = torch.arange(T * K, dtype=order.dtype,
                                    device=order.device)
        contrib = contrib[place].reshape(T, K, D)
        out = contrib[:, 0]
        for k in range(1, K):
            out = out + contrib[:, k]
    if rec.enabled:
        rec.tally("moe.pairs_held", ends[-1].to(torch.int64))
        sizes = torch.diff(ends, prepend=ends.new_zeros(1))
        rec.tally("moe.group_max", sizes.max().to(torch.int64), reduce="max")
    return out.reshape(B, S, D).to(dtype), aux


def moe_forward(p, x, cfg: ModelConfig, *, experts=None, layer: int = 0):
    """The MoE FFN of x (B, S, D) by ``cfg.moe.impl``, the shared experts
    added: (out, aux).  ``layer`` names the layer in the dropless path's
    spans.  The dropless path reads x through one float32 copy (the
    router's, cast back for the experts and the shared MLP), so that the
    input's gradient adds its uses in float32 and rounds once."""
    e = cfg.moe
    xs = x
    if e.impl == "dropless":
        if experts is not None:
            raise ValueError("the dropless MoE holds its experts itself")
        x32 = x.to(torch.float32)
        out, aux = moe_forward_dropless(p, x32, cfg, x.dtype, layer=layer)
        xs = x32.to(x.dtype)
    elif e.impl == "dense":
        out, aux = moe_forward_dense(p, x, cfg, experts=experts)
    else:
        if e.router_width != e.n_experts:
            raise ValueError("the capacity path holds every expert")
        out, aux = moe_forward_capacity(p, x, cfg, experts=experts)
    if "shared" in p:
        rec, args = trace.current()
        with rec.span("moe/shared", **args, layer=layer):
            out = out + mlp(p["shared"], xs, activation=cfg.activation)
    return out, aux
