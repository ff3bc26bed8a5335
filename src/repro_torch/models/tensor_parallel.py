"""The model over the ``"model"`` mesh axis: tensor parallelism of the
projections and the vocabulary, expert parallelism of the MoE (the port's
counterpart of what GSPMD makes of the reference's model under
``launch.sharding.param_specs``).

``params`` is a list of parameter trees, one per local shard of ``tp``
(a :class:`~repro_torch.launch.mesh.ModelAxis`): every leaf of a
``"model"`` spec holds that shard's piece, every replicated leaf is the
whole leaf (read from the first tree).  Each shard's work runs on its
pieces at their own shapes, and the shards meet only in ``tp``'s
operations, so M lanes of one process and M ranks give the same bits.

* Embedding and head, in the layout ``param_specs`` gives the table
  (the piece a shard holds shows it).  Vocab-parallel (V splits): a
  shard embeds the tokens of its rows (zero elsewhere) and the shards'
  embeddings are summed (exact: one is not zero); its logits are its
  vocabulary's, and the loss is a vocab-parallel cross entropy (the max
  and the sum of exponentials reduced over the shards, the target logit
  from its owner).  On ``d`` (V does not split, d does): each shard
  looks up its columns and the pieces are gathered.  Whole: one lookup.
  Where V does not split the head is whole (``lm_head``'s spec keeps it
  whole; a tied table split on ``d`` is gathered): the logits are
  computed once, replicated, and the loss is a plain cross entropy.
* Attention: ``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel, a
  shard running its query heads.  Where ``n_kv_heads`` does not split
  over M the K/V projections are replicated and each shard reads the KV
  heads its query heads map to; where ``n_heads`` does not (a shard
  boundary inside a head) the query projection's output is gathered and
  the attention runs whole on every shard before the row-parallel
  ``wo``.  MLA: ``wq_b``/``wkv_b`` column-parallel, ``wo`` row-parallel;
  the latents are replicated (every head reads all of them).  Where the
  heads do not split (minicpm3's 40 over 16) ``wq_b`` and ``wkv_b`` are
  gathered and the attention runs whole before the row-parallel ``wo``.
* MLP: ``up``/``gate`` column-parallel, ``down`` row-parallel.
* MoE: the router and the dispatch replicated; each shard runs its
  experts' slots, and their outputs are gathered so that ``combine`` adds
  each token's contributions in the global sorted order, as at M = 1.
* Mamba2: ``in_proj`` column-parallel over ``[z | xBC | dt]`` and the
  conv over ``[x | B | C]``, neither a clean set of heads: the projection
  and the conv's weights are gathered and the conv runs whole; each shard
  then runs the SSD of its heads (``A_log``, ``dt_bias``, ``D``), the
  gated norm reduces its sum of squares over the shards, and ``out_proj``
  is row-parallel.

Decode caches are one tree per local shard: its KV heads (or the KV heads
its query heads read), the whole MLA latent, its heads of the SSM state
and the whole conv window.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import moe as moe_lib
from . import multimodal
from . import ssm as ssm_lib
from .config import ModelConfig
from .layers import linear, mlp as mlp_dense, norm


def _first(ps, *keys):
    """A replicated leaf (or subtree), from the first shard's tree."""
    out = ps[0]
    for key in keys:
        out = out[key]
    return out


def _each(ps, *keys):
    outs = []
    for p in ps:
        for key in keys:
            p = p[key]
        outs.append(p)
    return outs


def _refuse(what: str):
    raise NotImplementedError(
        f"{what} does not split over the model axis; run it at model "
        f"size 1")


# ------------------------------------------------------- embed and head --

def _table_split(table, cfg: ModelConfig) -> str:
    """How the embedding's spec lays a shard's piece of the (V, d) table
    out: ``"vocab"`` (V/M rows), ``"d"`` (d/M columns) or ``"whole"``."""
    if table.shape[0] != cfg.vocab_size:
        return "vocab"
    return "d" if table.shape[1] != cfg.d_model else "whole"


def embed(tables, tokens, cfg: ModelConfig, tp):
    """The embedding (B, S, d), replicated: vocab-parallel (each shard's
    rows, zero for tokens it does not own, summed over the shards), on
    ``d`` (each shard's columns, gathered) or whole."""
    tok = tokens.to(torch.int64)
    split = _table_split(tables[0], cfg)
    if split == "whole":
        return F.embedding(tok, tables[0])
    if split == "d":
        return tp.gather([F.embedding(tok, t) for t in tables], -1)
    parts = []
    for table, m in zip(tables, tp.shards):
        Vm = table.shape[0]
        local = tok - m * Vm
        mine = (local >= 0) & (local < Vm)
        e = F.embedding(local.clamp(0, Vm - 1), table)
        parts.append(torch.where(mine[..., None], e, 0.0))
    return tp.sum(parts)


def head(ps, h, cfg: ModelConfig, tp):
    """The float32 logits: a list of the shards' (B, S, V/M) where the
    head is vocab-parallel, else ONE whole (B, S, V) tensor.  The whole
    head runs once on the replicated ``h``, so its gradients are whole on
    every shard; neither ``lm_head`` nor ``h`` passes ``copy_in`` (that
    would sum M whole gradients).  A tied table split on ``d`` is
    gathered first: the logits are the whole GEMM's, not a sum of the
    shards' partial products."""
    h = norm(cfg.norm, _first(ps, "final_norm"), h)
    if cfg.tie_embeddings:
        tables = _each(ps, "embed", "table")
        split = _table_split(tables[0], cfg)
        if split != "vocab":
            table = tables[0] if split == "whole" else tp.gather(tables, -1)
            return h.to(torch.float32) @ table.to(torch.float32).T
        hs = tp.copy_in(h)
        return [x.to(torch.float32) @ t.to(torch.float32).T
                for t, x in zip(tables, hs)]
    if _first(ps, "lm_head", "w").shape[-1] == cfg.vocab_size:
        return linear(_first(ps, "lm_head"), h).to(torch.float32)
    hs = tp.copy_in(h)
    return [linear(p["lm_head"], x).to(torch.float32) for p, x in zip(ps, hs)]


def _whole_logits(logits, tp):
    """``head``'s logits as one (B, S, V) tensor."""
    if isinstance(logits, torch.Tensor):
        return logits
    return tp.gather(logits, -1)


def cross_entropy(logits, tgt, tp):
    """The mean next-token cross entropy from ``head``'s logits (the
    shards' (B, S, V/M), or whole) and the targets (B, S) int64."""
    if isinstance(logits, torch.Tensor):
        from .model import next_token_nll
        return next_token_nll(logits, tgt)
    mx = tp.max([lg.amax(-1) for lg in logits])
    se = tp.sum([torch.sum(torch.exp(lg - mx[..., None]), dim=-1)
                 for lg in logits])
    lse = torch.log(se) + mx
    owned = []
    for lg, m in zip(logits, tp.shards):
        Vm = lg.shape[-1]
        local = tgt - m * Vm
        mine = (local >= 0) & (local < Vm)
        t = torch.gather(lg, -1, local.clamp(0, Vm - 1)[..., None])[..., 0]
        owned.append(torch.where(mine, t, 0.0))
    return torch.mean(lse - tp.sum(owned))


# ---------------------------------------------------------- attention --

def _rotate(cfg: ModelConfig, x, positions, layer_kind: str):
    """Rotate one (B,S,H,hd) tensor as ``_apply_positions`` rotates k."""
    return attn._apply_positions(cfg, x, x, positions,
                                 layer_kind=layer_kind)[1]


def _kv_heads_read(KH: int, H: int, M: int, m: int):
    """(first KV head, KV heads, query heads per KV head) that shard ``m``
    of ``H / M`` query heads reads when the K/V projections are whole; or
    None when its heads cross groups unevenly (they then read K/V expanded
    to one head per query head)."""
    G, Hs = H // KH, H // M
    h0 = m * Hs
    if Hs % G == 0:
        return h0 // G, Hs // G, G
    if G % Hs == 0:
        return h0 // G, 1, Hs
    return None


def kv_heads_of_shard(cfg: ModelConfig, M: int) -> int:
    """The KV heads a shard's cache holds."""
    H, KH = cfg.n_heads, cfg.n_kv_heads
    if H % M:
        return KH
    if KH % M == 0:
        return KH // M
    read = _kv_heads_read(KH, H, M, 0)
    return H // M if read is None else read[1]


def _kv_for_shard(k, KH: int, H: int, M: int, m: int):
    """The KV heads (B,S,*,hd) of whole ``k`` that shard ``m`` reads."""
    read = _kv_heads_read(KH, H, M, m)
    if read is not None:
        return k[:, :, read[0]:read[0] + read[1]]
    B, S, _, hd = k.shape
    Hs = H // M
    full = k[:, :, :, None].expand(B, S, KH, H // KH, hd).reshape(B, S, H, hd)
    return full[:, :, m * Hs:(m + 1) * Hs]


def _kv_sharded(ps, cfg: ModelConfig) -> bool:
    return _first(ps, "wk", "w").shape[-1] != cfg.n_kv_heads * cfg.hd


def gqa_forward(ps, x, positions, cfg: ModelConfig, tp, *,
                layer_kind: str = "attn", chunk_q: int = 512,
                return_kv: bool = False):
    """GQA over the model axis: (out (B,S,d), the shards' KVCaches or
    None)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    M = tp.size
    if _first(ps, "wq", "w").shape[-1] == H * hd:
        _refuse(f"the query projection of {H} x {hd}")
    xs = tp.copy_in(x)
    if H % M:
        # a shard boundary inside a head: gather the queries, attend whole
        q = tp.gather([linear(p["wq"], xj) for p, xj in zip(ps, xs)], -1)
        q = q.reshape(B, S, H, hd)
        k = linear(_first(ps, "wk"), x).reshape(B, S, KH, hd)
        v = linear(_first(ps, "wv"), x).reshape(B, S, KH, hd)
        q, k = attn._apply_positions(cfg, q, k, positions,
                                     layer_kind=layer_kind)
        o = attn.gqa_attend(q, k, v, cfg, layer_kind=layer_kind,
                            chunk_q=chunk_q).to(x.dtype)
        out = tp.sum([linear(p["wo"], oj)
                      for p, oj in zip(ps, tp.split(o, -1))])
        caches = [attn.gqa_cache_of(k, v, cfg, layer_kind=layer_kind)
                  for _ in tp.shards] if return_kv else None
        return out, caches
    Hs = H // M
    sharded_kv = _kv_sharded(ps, cfg)
    if not sharded_kv:
        k_all = _rotate(cfg, linear(_first(ps, "wk"), x).reshape(B, S, KH, hd),
                        positions, layer_kind)
        v_all = linear(_first(ps, "wv"), x).reshape(B, S, KH, hd)
        k_in, v_in = tp.copy_in(k_all), tp.copy_in(v_all)
    outs, caches = [], []
    for j, (p, m) in enumerate(zip(ps, tp.shards)):
        q = linear(p["wq"], xs[j]).reshape(B, S, Hs, hd)
        if sharded_kv:
            k = linear(p["wk"], xs[j]).reshape(B, S, KH // M, hd)
            v = linear(p["wv"], xs[j]).reshape(B, S, KH // M, hd)
            q, k = attn._apply_positions(cfg, q, k, positions,
                                         layer_kind=layer_kind)
        else:
            q = _rotate(cfg, q, positions, layer_kind)
            k = _kv_for_shard(k_in[j], KH, H, M, m)
            v = _kv_for_shard(v_in[j], KH, H, M, m)
        o = attn.gqa_attend(q, k, v, cfg, layer_kind=layer_kind,
                            chunk_q=chunk_q)
        outs.append(linear(p["wo"], o.to(x.dtype)))
        if return_kv:
            caches.append(attn.gqa_cache_of(k, v, cfg,
                                            layer_kind=layer_kind))
    return tp.sum(outs), (caches if return_kv else None)


def gqa_decode(ps, caches, x, pos: int, cfg: ModelConfig, tp, *,
               layer_kind: str = "attn", long_mode: bool = False):
    """One-token GQA decode over the model axis, each shard's cache
    written in place: out (B,1,d)."""
    B = x.shape[0]
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    M = tp.size
    L = caches[0].k.shape[1]
    if pos < 0 or (not attn._is_windowed(cfg, layer_kind, long_mode)
                   and pos >= L):
        raise IndexError(f"decode position {pos} outside the linear cache's "
                         f"{L} slots")
    if H % M:
        q = tp.gather([linear(p["wq"], x) for p in ps], -1)
        q = q.reshape(B, 1, H, hd)
        k = linear(_first(ps, "wk"), x).reshape(B, 1, KH, hd)
        v = linear(_first(ps, "wv"), x).reshape(B, 1, KH, hd)
        q, k = attn.gqa_decode_positions(cfg, q, k, pos,
                                         layer_kind=layer_kind)
        o = None
        for c in caches:
            o = attn.gqa_decode_attend(q, k, v, c, pos, cfg,
                                       layer_kind=layer_kind,
                                       long_mode=long_mode)
        return tp.sum([linear(p["wo"], oj) for p, oj in
                       zip(ps, tp.split(o.to(x.dtype), -1))])
    Hs = H // M
    sharded_kv = _kv_sharded(ps, cfg)
    if not sharded_kv:
        k_all = linear(_first(ps, "wk"), x).reshape(B, 1, KH, hd)
        v_all = linear(_first(ps, "wv"), x).reshape(B, 1, KH, hd)
        k_all = attn.gqa_decode_positions(cfg, k_all, k_all, pos,
                                          layer_kind=layer_kind)[1]
    outs = []
    for p, m, c in zip(ps, tp.shards, caches):
        q = linear(p["wq"], x).reshape(B, 1, Hs, hd)
        if sharded_kv:
            k = linear(p["wk"], x).reshape(B, 1, KH // M, hd)
            v = linear(p["wv"], x).reshape(B, 1, KH // M, hd)
            q, k = attn.gqa_decode_positions(cfg, q, k, pos,
                                             layer_kind=layer_kind)
        else:
            q = attn.gqa_decode_positions(cfg, q, q, pos,
                                          layer_kind=layer_kind)[0]
            k = _kv_for_shard(k_all, KH, H, M, m)
            v = _kv_for_shard(v_all, KH, H, M, m)
        o = attn.gqa_decode_attend(q, k, v, c, pos, cfg,
                                   layer_kind=layer_kind,
                                   long_mode=long_mode)
        outs.append(linear(p["wo"], o.to(x.dtype)))
    return tp.sum(outs)


def _mla_whole(ps, tp):
    """MLA's parameters with the column-parallel ``wq_b`` and ``wkv_b``
    gathered whole (their shards' boundaries cut through a head), so that
    every shard runs all the heads; the rest read from the first tree."""
    whole = dict(_first(ps))
    for key in ("wq_b", "wkv_b"):
        whole[key] = {k: tp.gather(_each(ps, key, k), -1)
                      for k in ps[0][key]}
    return whole


def mla_forward(ps, x, positions, cfg: ModelConfig, tp, *,
                chunk_q: int = 512, return_kv: bool = False, **_):
    """MLA over the model axis: (out, the shards' MLACaches or None).
    Where the heads do not split over the shards, ``wq_b`` and ``wkv_b``
    are gathered, the attention runs whole and ``wo`` stays
    row-parallel."""
    m = cfg.mla
    dh = m.qk_nope_head_dim + m.qk_rope_head_dim
    if _first(ps, "wq_b", "w").shape[-1] == cfg.n_heads * dh:
        _refuse(f"MLA's query projection of {cfg.n_heads} x {dh}")
    if cfg.n_heads % tp.size:
        whole = _mla_whole(ps, tp)
        q_nope, q_rope, c_kv, kr = attn._mla_qkv(whole, x, positions, cfg)
        k_nope, v = attn._mla_expand_kv(whole, c_kv, cfg)
        o = attn.mla_attend(q_nope, q_rope, k_nope, kr, v, cfg,
                            chunk_q=chunk_q).to(x.dtype)
        out = tp.sum([linear(p["wo"], oj)
                      for p, oj in zip(ps, tp.split(o, -1))])
        caches = [attn.MLACache(c_kv=c_kv.to(cfg.cdtype),
                                k_rope=kr[:, :, 0].to(cfg.cdtype))
                  for _ in tp.shards]
        return out, (caches if return_kv else None)
    q_lat, c_kv, k_rope = attn.mla_latents(_first(ps), x, cfg)
    qls, cs, krs = tp.copy_in(q_lat), tp.copy_in(c_kv), tp.copy_in(k_rope)
    outs, caches = [], []
    for j, p in enumerate(ps):
        q_nope, q_rope, kr = attn.mla_heads(p, qls[j], krs[j], positions, cfg)
        k_nope, v = attn._mla_expand_kv(p, cs[j], cfg)
        o = attn.mla_attend(q_nope, q_rope, k_nope, kr, v, cfg,
                            chunk_q=chunk_q)
        outs.append(linear(p["wo"], o.to(x.dtype)))
        if return_kv:
            caches.append(attn.MLACache(c_kv=c_kv.to(cfg.cdtype),
                                        k_rope=kr[:, :, 0].to(cfg.cdtype)))
    return tp.sum(outs), (caches if return_kv else None)


def mla_decode(ps, caches, x, pos: int, cfg: ModelConfig, tp, **_):
    """One-token MLA decode over the model axis (absorbed or expanded):
    out (B,1,d); heads that do not split run whole, as in
    :func:`mla_forward`."""
    B = x.shape[0]
    L = caches[0].c_kv.shape[1]
    if not 0 <= pos < L:
        raise IndexError(f"decode position {pos} outside the linear cache's "
                         f"{L} slots")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_lat, c_kv, k_rope = attn.mla_latents(_first(ps), x, cfg)
    if cfg.n_heads % tp.size:
        whole = _mla_whole(ps, tp)
        q_nope, q_rope, kr = attn.mla_heads(whole, q_lat, k_rope, positions,
                                            cfg)
        for c in caches:
            attn.mla_cache_write(c, c_kv, kr, pos)
        o = attn.mla_decode_attend(whole, caches[0], q_nope, q_rope, pos,
                                   cfg).to(x.dtype)
        return tp.sum([linear(p["wo"], oj)
                       for p, oj in zip(ps, tp.split(o, -1))])
    outs = []
    for p, c in zip(ps, caches):
        q_nope, q_rope, kr = attn.mla_heads(p, q_lat, k_rope, positions, cfg)
        attn.mla_cache_write(c, c_kv, kr, pos)
        o = attn.mla_decode_attend(p, c, q_nope, q_rope, pos, cfg)
        outs.append(linear(p["wo"], o.to(x.dtype)))
    return tp.sum(outs)


# ------------------------------------------------------------ mlp, moe --

def mlp(ps, x, tp, *, activation: str, width: int):
    """Column-parallel up/gate, row-parallel down (``width`` the whole
    hidden width)."""
    if _first(ps, "up", "w").shape[-1] == width:
        _refuse(f"the MLP's width {width}")
    xs = tp.copy_in(x)
    return tp.sum([mlp_dense(p, xj, activation=activation)
                   for p, xj in zip(ps, xs)])


def moe_forward(ps, x, cfg: ModelConfig, tp):
    """Expert parallelism: the router and dispatch replicated, each shard
    its experts' rows of the (E, ., D) buffer, their outputs gathered."""
    if _first(ps, "moe", "up").shape[0] == cfg.moe.n_experts:
        _refuse(f"{cfg.moe.n_experts} experts")

    def experts(h):
        return tp.gather([moe_lib._expert_ffn(p["moe"], hj, cfg)
                          for p, hj in zip(ps, tp.split(h, 0))], 0)

    return moe_lib.moe_forward(_first(ps, "moe"), x, cfg, experts=experts)


def ffn(ps, hn, cfg: ModelConfig, tp):
    if cfg.moe is not None:
        return moe_forward(ps, hn, cfg, tp)
    return mlp([p["mlp"] for p in ps], hn, tp, activation=cfg.activation,
               width=cfg.d_ff), None


# -------------------------------------------------------------- mamba2 --

def _ssm_split(cfg: ModelConfig, tp):
    s, d_in, nh, _ = ssm_lib._dims(cfg)
    M = tp.size
    if nh % M or (s.n_groups > 1 and s.n_groups % M):
        _refuse(f"the SSM's {nh} heads in {s.n_groups} groups")
    return s, d_in, nh, nh // M


def _ssm_heads(p, x_m, dt_m, Bm, Cm, z_m, cfg: ModelConfig, *, chunk=None,
               state=None):
    """One shard's heads: y (B, S, d_in/M) before the norm, and its final
    state (the SSD chunked) or new state (``state`` given: one recurrent
    step, S = 1)."""
    s = cfg.ssm
    dt = F.softplus(dt_m.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    Bsz, S = x_m.shape[:2]
    xs = x_m.reshape(Bsz, S, -1, s.head_dim)
    if state is None:
        y, new = ssm_lib.ssd_chunked(xs, dt, A, Bm, Cm, chunk=chunk)
    else:
        nhs = xs.shape[2]
        hpg = nhs // Bm.shape[2]
        Bh = Bm[:, 0].repeat_interleave(hpg, dim=1)              # (B,H,N)
        Ch = Cm[:, 0].repeat_interleave(hpg, dim=1)
        decay = torch.exp(dt[:, 0] * A)
        new = (state * decay[..., None, None]
               + (dt[:, 0, :, None] * xs[:, 0])[..., :, None]
               * Bh[:, :, None, :])
        y = (new @ Ch[..., None])[..., 0][:, None]               # (B,1,H,P)
    y = y + p["D"].to(torch.float32)[:, None] * xs
    return y.reshape(Bsz, S, -1) * F.silu(z_m.to(torch.float32)), new


def _gated_out(ps, ys, scales, x_dtype, d_in: int, tp):
    """The gated RMSNorm over all d_in (the shards' sums of squares
    reduced) and the row-parallel ``out_proj``."""
    yc = [y.to(x_dtype) for y in ys]
    ss = tp.sum([torch.sum(torch.square(y.to(torch.float32)), dim=-1,
                           keepdim=True) for y in yc])
    # the norm factor is replicated: each shard reads it through copy_in
    rs = tp.copy_in(torch.rsqrt(ss / d_in + 1e-6))
    return tp.sum([linear(p["out_proj"],
                          (y.to(torch.float32) * r
                           * sc.to(torch.float32)).to(x_dtype))
                   for p, y, r, sc in zip(ps, yc, rs, scales)])


def _groups_of(t, cfg: ModelConfig, m: int, M: int):
    """The B or C groups (B, S, G, N) that shard ``m``'s heads read."""
    G = cfg.ssm.n_groups
    if G == 1:
        return t
    return t[:, :, m * (G // M):(m + 1) * (G // M)]


def mamba_forward(ps, x, cfg: ModelConfig, tp, *, return_state=False):
    """The Mamba2 mixer over the model axis: (out, the shards' SSMCaches
    or None)."""
    s, d_in, nh, nhs = _ssm_split(cfg, tp)
    mp = [p["mamba"] for p in ps]
    Bsz, S, _ = x.shape
    gn = s.n_groups * s.d_state
    xs = tp.copy_in(x)
    proj = tp.gather([linear(p["in_proj"], xj) for p, xj in zip(mp, xs)], -1)
    conv_w = tp.gather(_each(mp, "conv_w"), -1)
    conv_b = tp.gather(_each(mp, "conv_b"), 0)
    z, xBC_raw, dt = ssm_lib._split_proj(cfg, proj)
    xBC = ssm_lib._causal_conv(xBC_raw, conv_w, conv_b)
    Bm = xBC[..., d_in:d_in + gn].reshape(Bsz, S, s.n_groups, s.d_state)
    Cm = xBC[..., d_in + gn:].reshape(Bsz, S, s.n_groups, s.d_state)
    parts = zip(mp, tp.shards, tp.split(xBC[..., :d_in], -1),
                tp.split(dt, -1), tp.copy_in(Bm), tp.copy_in(Cm),
                tp.split(z, -1))
    ys, states = [], []
    for p, m, x_m, dt_m, b, c, z_m in parts:
        y, st = _ssm_heads(p, x_m, dt_m, _groups_of(b, cfg, m, tp.size),
                           _groups_of(c, cfg, m, tp.size), z_m, cfg,
                           chunk=s.chunk)
        ys.append(y)
        states.append(st)
    out = _gated_out(mp, ys, tp.split(_first(mp, "norm", "scale"), 0),
                     x.dtype, d_in, tp)
    if not return_state:
        return out, None
    K = s.d_conv
    tail = xBC_raw[:, S - (K - 1):] if S >= K - 1 else \
        F.pad(xBC_raw, (0, 0, K - 1 - S, 0))
    return out, [ssm_lib.SSMCache(state=st, conv=tail.to(cfg.cdtype))
                 for st in states]


def mamba_decode(ps, caches, x, pos, cfg: ModelConfig, tp):
    """One recurrent step over the model axis, each shard's state and
    conv window written in place: out (B,1,d)."""
    s, d_in, nh, nhs = _ssm_split(cfg, tp)
    mp = [p["mamba"] for p in ps]
    Bsz = x.shape[0]
    gn = s.n_groups * s.d_state
    proj = tp.gather([linear(p["in_proj"], x[:, 0]) for p in mp], -1)
    conv_w = tp.gather(_each(mp, "conv_w"), -1)
    conv_b = tp.gather(_each(mp, "conv_b"), 0)
    z, xBC, dt = ssm_lib._split_proj(cfg, proj)
    hist = torch.cat([caches[0].conv.to(torch.float32),
                      xBC[:, None].to(torch.float32)], dim=1)   # (B, K, C)
    xBC_c = F.silu(torch.einsum("bkc,kc->bc", hist,
                                conv_w.to(torch.float32))
                   + conv_b.to(torch.float32))
    for c in caches:
        c.conv.copy_(hist[:, 1:])
    Bm = xBC_c[..., d_in:d_in + gn].reshape(Bsz, 1, s.n_groups, s.d_state)
    Cm = xBC_c[..., d_in + gn:].reshape(Bsz, 1, s.n_groups, s.d_state)
    ys = []
    for p, m, c, x_m, dt_m, z_m in zip(
            mp, tp.shards, caches, tp.split(xBC_c[:, None, :d_in], -1),
            tp.split(dt[:, None], -1), tp.split(z[:, None], -1)):
        y, st = _ssm_heads(p, x_m, dt_m, _groups_of(Bm, cfg, m, tp.size),
                           _groups_of(Cm, cfg, m, tp.size), z_m, cfg,
                           state=c.state)
        c.state.copy_(st)
        ys.append(y)
    return _gated_out(mp, ys, tp.split(_first(mp, "norm", "scale"), 0),
                      x.dtype, d_in, tp)


# --------------------------------------------------------------- model --

def _unit_trees(ps, n_units: int):
    """Per unit, the list of the shards' unit trees."""
    from .model import _unit_slices
    per = [_unit_slices(p["units"], n_units) for p in ps]
    return [[per[j][u] for j in range(len(ps))] for u in range(n_units)]


def _shared_block(sps, h, positions, cfg: ModelConfig, tp, want_cache):
    if positions.dim() == 3:
        positions = positions[0]
    out, kv = gqa_forward([p["attn"] for p in sps],
                          norm(cfg.norm, _first(sps, "norm1"), h),
                          positions, cfg, tp, layer_kind="attn",
                          return_kv=want_cache)
    h = h + out
    h = h + mlp([p["mlp"] for p in sps], norm(cfg.norm, _first(sps, "norm2"),
                                               h), tp,
                activation=cfg.activation, width=_shared_width(cfg))
    return h, kv


def _shared_width(cfg: ModelConfig) -> int:
    return max(cfg.d_ff, 4 * cfg.d_model)


def _block(bps, h, positions, cfg: ModelConfig, kind, sps, tp, want_cache):
    """One block: (h, aux or None, the shards' caches or None)."""
    if kind in ("mamba", "mamba_attn"):
        out, ssm_caches = mamba_forward(
            bps, norm(cfg.norm, _first(bps, "norm1"), h), cfg, tp,
            return_state=want_cache)
        h = h + out
        caches = [{"ssm": c} for c in ssm_caches] if want_cache else None
        if kind == "mamba_attn" and sps is not None:
            h, kv = _shared_block(sps, h, positions, cfg, tp, want_cache)
            if want_cache:
                for c, k in zip(caches, kv):
                    c["shared"] = k
        return h, None, caches
    fwd = mla_forward if cfg.attention == "mla" else gqa_forward
    out, caches = fwd([p["attn"] for p in bps],
                      norm(cfg.norm, _first(bps, "norm1"), h), positions,
                      cfg, tp, layer_kind=kind, return_kv=want_cache)
    h = h + out
    out, aux = ffn(bps, norm(cfg.norm, _first(bps, "norm2"), h), cfg, tp)
    return h + out, aux, caches


def forward_parts(ps, tokens, cfg: ModelConfig, tp, *, frontend_embeds=None,
                  want_cache: bool = False, remat: bool = False,
                  last_only: bool = False):
    """(``head``'s float32 logits, aux, the shards' cache trees or
    None): ``model._forward`` over the model axis.  With ``last_only`` the
    head runs on the last position alone."""
    from .model import _abs_pos, _positions_for, _sinusoidal, _stack_caches
    pattern, n_units = cfg.unit_pattern()
    B, S = tokens.shape
    h = embed(_each(ps, "embed", "table"), tokens, cfg, tp).to(cfg.cdtype)
    h = multimodal.merge_frontend(cfg, h, frontend_embeds)
    positions = _positions_for(cfg, B, S, tokens.device)
    if _abs_pos(cfg):
        p = positions if positions.dim() == 2 else positions[0]
        h = h + _sinusoidal(cfg.d_model, p).to(h.dtype)
    sps = [p["shared"] for p in ps] if "shared" in ps[0] else None

    def unit_fn(h, lb, rz, unit_ps):
        caches = {}
        for i, kind in enumerate(pattern):
            h, aux, caches[f"b{i}"] = _block(
                [u[f"b{i}"] for u in unit_ps], h, positions, cfg, kind, sps,
                tp, want_cache)
            if aux is not None:
                lb = lb + aux["load_balance"]
                rz = rz + aux["router_z"]
        return h, lb, rz, caches

    lb = torch.zeros((), dtype=torch.float32, device=tokens.device)
    rz = torch.zeros((), dtype=torch.float32, device=tokens.device)
    unit_caches = []
    for unit_ps in _unit_trees(ps, n_units):
        if remat:
            h, lb, rz, caches = checkpoint(unit_fn, h, lb, rz, unit_ps,
                                           use_reentrant=False)
        else:
            h, lb, rz, caches = unit_fn(h, lb, rz, unit_ps)
        unit_caches.append(caches)
    logits = head(ps, h[:, -1:] if last_only else h, cfg, tp)
    aux = {"load_balance": lb / cfg.n_layers, "router_z": rz / cfg.n_layers}
    if not want_cache:
        return logits, aux, None
    trees = [_stack_caches([{key: val[j] for key, val in uc.items()}
                            for uc in unit_caches])
             for j in range(len(ps))]
    return logits, aux, trees


def loss_fn(ps, batch, cfg: ModelConfig, tp, *, remat: bool = False):
    """``model.loss_fn`` over the model axis: (loss, metrics), the same
    on every shard."""
    tokens = batch["tokens"]
    logits, aux, _ = forward_parts(ps, tokens, cfg, tp,
                                   frontend_embeds=batch.get(
                                       "frontend_embeds"), remat=remat)
    logits = logits[:, :-1] if isinstance(logits, torch.Tensor) else \
        [lg[:, :-1] for lg in logits]
    nll = cross_entropy(logits, tokens[:, 1:].to(torch.int64), tp)
    loss = nll
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * (
            aux["load_balance"] + aux["router_z"])
    return loss, {"nll": nll, **aux}


def prefill(ps, tokens, cfg: ModelConfig, tp, *, frontend_embeds=None,
            max_len: int | None = None):
    """``model.prefill`` over the model axis: (last-position logits
    (B,1,V), the shards' caches, aux)."""
    from .model import _pad_caches
    logits, aux, trees = forward_parts(ps, tokens, cfg, tp,
                                       frontend_embeds=frontend_embeds,
                                       want_cache=True, last_only=True)
    if max_len is not None:
        trees = [_pad_caches(t, tokens.shape[1], max_len) for t in trees]
    return _whole_logits(logits, tp), trees, aux


def decode_step(ps, caches, token, pos, cfg: ModelConfig, tp, *,
                long_mode: bool = False):
    """``model.decode_step`` over the model axis, each shard's caches
    written in place: (logits (B,1,V) float32, caches)."""
    import operator

    from .model import _abs_pos, _sinusoidal, _unit_view
    pos = operator.index(pos)
    pattern, n_units = cfg.unit_pattern()
    B = token.shape[0]
    h = embed(_each(ps, "embed", "table"), token, cfg, tp).to(cfg.cdtype)
    if _abs_pos(cfg):
        p = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
        h = h + _sinusoidal(cfg.d_model, p).to(h.dtype)
    sps = [p["shared"] for p in ps] if "shared" in ps[0] else None
    dec = mla_decode if cfg.attention == "mla" else gqa_decode
    for u, unit_ps in enumerate(_unit_trees(ps, n_units)):
        for i, kind in enumerate(pattern):
            bps = [up[f"b{i}"] for up in unit_ps]
            cs = [_unit_view(c[f"b{i}"], u) for c in caches]
            if kind in ("mamba", "mamba_attn"):
                h = h + mamba_decode(bps, [c["ssm"] for c in cs],
                                     norm(cfg.norm, _first(bps, "norm1"), h),
                                     pos, cfg, tp)
                if kind == "mamba_attn" and sps is not None:
                    h = h + gqa_decode(
                        [p["attn"] for p in sps], [c["shared"] for c in cs],
                        norm(cfg.norm, _first(sps, "norm1"), h), pos, cfg,
                        tp, layer_kind="attn", long_mode=long_mode)
                    h = h + mlp([p["mlp"] for p in sps],
                                norm(cfg.norm, _first(sps, "norm2"), h), tp,
                                activation=cfg.activation,
                                width=_shared_width(cfg))
                continue
            h = h + dec([p["attn"] for p in bps], cs,
                        norm(cfg.norm, _first(bps, "norm1"), h), pos, cfg,
                        tp, layer_kind=kind, long_mode=long_mode)
            out, _ = ffn(bps, norm(cfg.norm, _first(bps, "norm2"), h), cfg,
                         tp)
            h = h + out
    return _whole_logits(head(ps, h, cfg, tp), tp), caches


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, tp, *,
                long_mode: bool = False, device=None):
    """Each local shard's zero caches: ``model.init_caches`` with a KV
    cache of the shard's KV heads (:func:`kv_heads_of_shard`) and an SSM
    state of its heads."""
    from .model import init_caches as whole
    M = tp.size
    kv = kv_heads_of_shard(cfg, M)

    def cut(node):
        if isinstance(node, attn.KVCache):
            shape = node.k.shape[:-2] + (kv, node.k.shape[-1])
            return attn.KVCache(node.k.new_zeros(shape),
                                node.v.new_zeros(shape))
        if isinstance(node, ssm_lib.SSMCache):
            st = node.state
            return ssm_lib.SSMCache(
                state=st.new_zeros(st.shape[:-3] + (st.shape[-3] // M,)
                                   + st.shape[-2:]),
                conv=node.conv)
        if isinstance(node, dict):
            return {key: cut(val) for key, val in node.items()}
        return node

    return [cut(whole(cfg, batch, seq_len, long_mode=long_mode,
                      device=device)) for _ in tp.shards]
