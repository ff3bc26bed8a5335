"""Model assembly: decoder-only LM over heterogeneous block stacks
(PyTorch port of ``repro.models.model``).

The parameters are the reference's nested dict, key for key: ``embed``,
``final_norm``, ``lm_head`` (when not tied), ``shared`` (the hybrid's one
attention block) and ``units.b{i}.…``, each unit leaf stacked over the
units on a leading dim.  ``forward`` walks the units in a Python loop,
each reading its slice of the stacked leaves (the reference's
``lax.scan``).  An attention block is GQA or MLA, its FFN the dense MLP
or, when ``cfg.moe`` is set, the MoE (``models.moe``), whose router aux
losses are averaged over the layers.  A ``mamba`` block is the Mamba2/SSD
mixer (``models.ssm``); a ``mamba_attn`` block follows it with the shared
attention block (zamba2).  The modality families take the frontend's
patch or frame embeddings in place of the first ``frontend_tokens``
positions (``models.multimodal``); qwen2-vl rotates by M-RoPE over the
patch grid's (t, h, w) positions.

Three entry points per architecture x input shape:
  forward / loss_fn  -- training shapes
  prefill            -- forward + KV/MLA/SSM cache construction
  decode_step        -- one token against the caches (the serve step),
                        which it updates in place
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import attention as attn
from . import moe as moe_lib
from . import multimodal
from . import ssm as ssm_lib
from .config import ModelConfig
from .layers import (Init, embed, embedding_init, linear, linear_init, mlp,
                     mlp_init, norm, norm_init, unembed)


# ------------------------------------------------------------------- init --

def _block_init(init: Init, cfg: ModelConfig, kind: str):
    if kind in ("mamba", "mamba_attn"):
        return {
            "norm1": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
            "mamba": ssm_lib.mamba_init(init, cfg),
        }
    p = {
        "norm1": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
        "attn": (attn.mla_init if cfg.attention == "mla"
                 else attn.gqa_init)(init, cfg),
        "norm2": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_init(init, cfg)
    else:
        p["mlp"] = mlp_init(init, cfg.d_model, cfg.d_ff,
                            activation=cfg.activation, dtype=cfg.pdtype)
    return p


def _shared_block_init(init: Init, cfg: ModelConfig):
    """The hybrid's one attention block (unstacked), applied after every
    ``mamba_attn`` block's mixer; its MLP is ``max(d_ff, 4 d_model)``
    wide."""
    return {
        "norm1": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
        "attn": attn.gqa_init(init, cfg),
        "norm2": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
        "mlp": mlp_init(init, cfg.d_model, max(cfg.d_ff, 4 * cfg.d_model),
                        activation=cfg.activation, dtype=cfg.pdtype),
    }


def _has_shared(cfg: ModelConfig, pattern) -> bool:
    return cfg.shared_attention and "mamba_attn" in pattern


def _init(init: Init, cfg: ModelConfig):
    pattern, n_units = cfg.unit_pattern()
    params: dict = {
        "embed": embedding_init(init, cfg.vocab_size, cfg.d_model,
                                dtype=cfg.pdtype),
        "final_norm": norm_init(init, cfg.norm, cfg.d_model,
                                dtype=cfg.pdtype),
    }
    units = init.stacked(n_units)
    params["units"] = {f"b{i}": _block_init(units, cfg, kind)
                       for i, kind in enumerate(pattern)}
    if _has_shared(cfg, pattern):
        params["shared"] = _shared_block_init(init, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(init, cfg.d_model, cfg.vocab_size,
                                        dtype=cfg.pdtype)
    return params


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (None = the card).  The same seed on the same device gives
    the same bits."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _init(Init(gen, device), cfg)


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors: shapes and dtypes, no
    storage."""
    return _init(Init(None, "meta"), cfg)


# ---------------------------------------------------------------- forward --

def _ffn(bp, hn, cfg: ModelConfig):
    """The block's FFN on its normed input: (out, aux), the MoE's router
    losses or None for the dense MLP."""
    if cfg.moe is not None:
        return moe_lib.moe_forward(bp["moe"], hn, cfg)
    return mlp(bp["mlp"], hn, activation=cfg.activation), None


def _apply_shared(shared, h, positions, cfg: ModelConfig, *,
                  want_cache: bool = False):
    """The shared attention block: (h, its KVCache or None).  It takes the
    first stream of three-stream positions."""
    if positions.dim() == 3:
        positions = positions[0]
    out = attn.gqa_forward(shared["attn"], norm(cfg.norm, shared["norm1"], h),
                           positions, cfg, layer_kind="attn",
                           return_kv=want_cache)
    cache = None
    if want_cache:
        out, cache = out
    h = h + out
    h = h + mlp(shared["mlp"], norm(cfg.norm, shared["norm2"], h),
                activation=cfg.activation)
    return h, cache


def _apply_block(bp, h, positions, cfg: ModelConfig, kind: str, shared, *,
                 want_cache: bool = False):
    """One block: (h, its aux losses or None, the layer's cache or None:
    a KVCache or MLACache, or for a mamba block ``{"ssm": SSMCache}`` and,
    after the shared attention, ``"shared": KVCache``)."""
    if kind in ("mamba", "mamba_attn"):
        out = ssm_lib.mamba_forward(bp["mamba"],
                                    norm(cfg.norm, bp["norm1"], h), cfg,
                                    return_state=want_cache)
        cache = None
        if want_cache:
            out, ssm_cache = out
            cache = {"ssm": ssm_cache}
        h = h + out
        if kind == "mamba_attn" and shared is not None:
            h, kv = _apply_shared(shared, h, positions, cfg,
                                  want_cache=want_cache)
            if want_cache:
                cache["shared"] = kv
        return h, None, cache
    fwd = attn.mla_forward if cfg.attention == "mla" else attn.gqa_forward
    out = fwd(bp["attn"], norm(cfg.norm, bp["norm1"], h), positions, cfg,
              layer_kind=kind, return_kv=want_cache)
    cache = None
    if want_cache:
        out, cache = out
    h = h + out
    out, aux = _ffn(bp, norm(cfg.norm, bp["norm2"], h), cfg)
    return h + out, aux, cache


def _positions_for(cfg: ModelConfig, batch: int, seq_len: int, device):
    """(B, S) int32 positions, or M-RoPE's (3, B, S) (t, h, w) ids."""
    if cfg.rope == "mrope":
        return multimodal.mrope_positions(cfg, batch, seq_len, device=device)
    return torch.arange(seq_len, dtype=torch.int32,
                        device=device)[None].expand(batch, seq_len)


def _abs_pos(cfg: ModelConfig) -> bool:
    """Whether the model adds sinusoidal positions: ``rope='none'``
    outside the SSM and hybrid families (mamba2 has no positions)."""
    return cfg.rope == "none" and cfg.arch_type not in ("ssm", "hybrid")


def _sinusoidal(d_model: int, positions):
    """Absolute sinusoidal embeddings (musicgen-style decoders, rope='none').

    positions: (B, S) -> (B, S, d_model)."""
    half = d_model // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0))
                      * torch.arange(half) / half).to(positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _unit_slices(units, n_units: int):
    """The stacked unit tree as one tree per unit (views), through ONE
    ``unbind`` per leaf: its backward stacks the units' gradients into
    the stacked leaf's, where a slice per unit would add a zero-filled
    copy of the whole leaf per unit."""
    if isinstance(units, dict):
        per = {key: _unit_slices(val, n_units) for key, val in units.items()}
        return [{key: per[key][u] for key in per} for u in range(n_units)]
    return units.unbind(0)


def _head(params, h, cfg: ModelConfig):
    h = norm(cfg.norm, params["final_norm"], h)
    if cfg.tie_embeddings:
        return unembed(params["embed"], h)
    return linear(params["lm_head"], h).to(torch.float32)


def _forward(params, tokens, cfg: ModelConfig, *, frontend_embeds=None,
             want_cache: bool = False, remat: bool = False):
    """(logits (B, S, V) float32, aux, caches stacked over the units or
    None): ``forward``'s work, with the router's aux losses each summed
    over the layers in order and divided by ``cfg.n_layers`` (zeros for
    the dense family), as the reference's ``forward`` returns them.  The
    frontend's embeddings replace the first positions before the
    sinusoidal positions are added, as in the reference, so they get
    theirs too."""
    pattern, n_units = cfg.unit_pattern()
    B, S = tokens.shape
    h = embed(params["embed"], tokens).to(cfg.cdtype)
    h = multimodal.merge_frontend(cfg, h, frontend_embeds)
    positions = _positions_for(cfg, B, S, tokens.device)
    if _abs_pos(cfg):
        p = positions if positions.dim() == 2 else positions[0]
        h = h + _sinusoidal(cfg.d_model, p).to(h.dtype)
    shared = params.get("shared")

    def unit_fn(h, lb, rz, unit_params):
        caches = {}
        for i, kind in enumerate(pattern):
            h, aux, caches[f"b{i}"] = _apply_block(
                unit_params[f"b{i}"], h, positions, cfg, kind, shared,
                want_cache=want_cache)
            if aux is not None:
                lb = lb + aux["load_balance"]
                rz = rz + aux["router_z"]
        return h, lb, rz, caches

    lb = torch.zeros((), dtype=torch.float32, device=tokens.device)
    rz = torch.zeros((), dtype=torch.float32, device=tokens.device)
    unit_caches = []
    for unit_params in _unit_slices(params["units"], n_units):
        if remat:
            h, lb, rz, caches = checkpoint(unit_fn, h, lb, rz, unit_params,
                                           use_reentrant=False)
        else:
            h, lb, rz, caches = unit_fn(h, lb, rz, unit_params)
        unit_caches.append(caches)
    logits = _head(params, h, cfg)
    aux = {"load_balance": lb / cfg.n_layers, "router_z": rz / cfg.n_layers}
    if not want_cache:
        return logits, aux, None
    return logits, aux, _stack_caches(unit_caches)


def _stack_caches(unit_caches):
    """One cache tree per unit -> one tree whose leaves are stacked over
    the units (every cache type: dicts and named tuples)."""
    first = unit_caches[0]
    if isinstance(first, dict):
        return {key: _stack_caches([c[key] for c in unit_caches])
                for key in first}
    if isinstance(first, tuple):
        return type(first)(*(_stack_caches(list(leaves))
                             for leaves in zip(*unit_caches)))
    return torch.stack(unit_caches)


def _unit_view(cache, u: int):
    """Unit ``u``'s views of a stacked cache tree (written in place)."""
    if isinstance(cache, dict):
        return {key: _unit_view(val, u) for key, val in cache.items()}
    if isinstance(cache, tuple):
        return type(cache)(*(leaf[u] for leaf in cache))
    return cache[u]


def forward(params, tokens, cfg: ModelConfig, *, frontend_embeds=None,
            want_cache: bool = False, remat: bool = False):
    """tokens: (B, S) int -> logits (B, S, V) float32 (and, when
    ``want_cache``, the caches stacked over the units, for prefill).

    ``remat=True`` checkpoints each unit (activation recomputation in the
    backward pass).  The MoE's aux losses reach ``loss_fn`` and
    ``prefill``."""
    logits, _, caches = _forward(params, tokens, cfg,
                                 frontend_embeds=frontend_embeds,
                                 want_cache=want_cache, remat=remat)
    return (logits, caches) if want_cache else logits


def _sharded(tp) -> bool:
    return tp is not None and tp.size > 1


def next_token_nll(logits, tgt):
    """The mean cross entropy of float32 logits (B, S, V) against the
    targets (B, S) int64."""
    lse = torch.logsumexp(logits, dim=-1)
    # the target logit by a gather: the reference's one-hot sum has the
    # same value for finite logits
    tgt_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
    return torch.mean(lse - tgt_logit)


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False,
            tp=None):
    """batch: {"tokens": (B,S), optional "frontend_embeds" (B, n, d)}.
    Next-token cross entropy (+ the MoE's aux losses, weighted by
    ``router_aux_weight``).  Returns (loss, metrics): ``nll``,
    ``load_balance`` and ``router_z`` (zeros for the dense family), as the
    reference's.  Over a model axis ``tp`` of size > 1, ``params`` is the
    list of the local shards' trees (``models.tensor_parallel``)."""
    if _sharded(tp):
        from . import tensor_parallel
        return tensor_parallel.loss_fn(params, batch, cfg, tp, remat=remat)
    tokens = batch["tokens"]
    logits, aux, _ = _forward(params, tokens, cfg,
                              frontend_embeds=batch.get("frontend_embeds"),
                              remat=remat)
    nll = next_token_nll(logits[:, :-1], tokens[:, 1:].to(torch.int64))
    loss = nll
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * (
            aux["load_balance"] + aux["router_z"])
    return loss, {"nll": nll, **aux}


# ------------------------------------------------------------ serve paths --

def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                long_mode: bool = False, device=None, tp=None):
    """Zero caches, one a block of the unit pattern, each leaf stacked
    over the units on ``device`` (None = the card; ``"meta"`` for shapes
    only): a :class:`~repro_torch.models.attention.KVCache` ``(n_units,
    batch, L, KH, hd)`` or an ``MLACache`` for attention blocks; for a
    mamba block ``{"ssm": SSMCache}`` and, where the shared attention
    follows, ``"shared": KVCache``.  The reference broadcasts one unit's
    zeros; these are allocated whole, since decode writes them in
    place.  Over a model axis ``tp`` of size > 1: one tree per local
    shard."""
    device = resolve_device(device)
    if _sharded(tp):
        from . import tensor_parallel
        return tensor_parallel.init_caches(cfg, batch, seq_len, tp,
                                           long_mode=long_mode,
                                           device=device)
    pattern, n_units = cfg.unit_pattern()
    lead = (n_units,)

    def one(kind):
        if kind in ("mamba", "mamba_attn"):
            c = {"ssm": ssm_lib.mamba_init_cache(cfg, batch, lead=lead,
                                                 device=device)}
            if kind == "mamba_attn" and cfg.shared_attention:
                c["shared"] = attn.gqa_init_cache(
                    cfg, batch, seq_len, layer_kind="attn",
                    long_mode=long_mode, lead=lead, device=device)
            return c
        if cfg.attention == "mla":
            return attn.mla_init_cache(cfg, batch, seq_len, lead=lead,
                                       device=device)
        return attn.gqa_init_cache(cfg, batch, seq_len, layer_kind=kind,
                                   long_mode=long_mode, lead=lead,
                                   device=device)

    return {f"b{i}": one(kind) for i, kind in enumerate(pattern)}


def decode_step(params, caches, token, pos, cfg: ModelConfig, *,
                long_mode: bool = False, tp=None):
    """The serve step: one new token per sequence against the caches.

    token: (B, 1) int; pos: the current position, a Python int.  Writes
    each layer's K/V, latents or SSM state into ``caches`` in place and
    returns (logits (B, 1, V) float32, caches).  Over a model axis ``tp``
    of size > 1, ``params`` and ``caches`` are lists of the local shards'
    trees."""
    if _sharded(tp):
        from . import tensor_parallel
        return tensor_parallel.decode_step(params, caches, token, pos, cfg,
                                           tp, long_mode=long_mode)
    pattern, n_units = cfg.unit_pattern()
    B = token.shape[0]
    h = embed(params["embed"], token).to(cfg.cdtype)
    if _abs_pos(cfg):
        p = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
        h = h + _sinusoidal(cfg.d_model, p).to(h.dtype)
    shared = params.get("shared")
    dec = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    for u, unit_params in enumerate(_unit_slices(params["units"], n_units)):
        for i, kind in enumerate(pattern):
            # the unit's views of the stacked cache, written in place
            bp, c = unit_params[f"b{i}"], _unit_view(caches[f"b{i}"], u)
            if kind in ("mamba", "mamba_attn"):
                out, _ = ssm_lib.mamba_decode(
                    bp["mamba"], c["ssm"], norm(cfg.norm, bp["norm1"], h),
                    pos, cfg)
                h = h + out
                if kind == "mamba_attn" and shared is not None:
                    out, _ = attn.gqa_decode(
                        shared["attn"], c["shared"],
                        norm(cfg.norm, shared["norm1"], h), pos, cfg,
                        layer_kind="attn", long_mode=long_mode)
                    h = h + out
                    h = h + mlp(shared["mlp"],
                                norm(cfg.norm, shared["norm2"], h),
                                activation=cfg.activation)
                continue
            out, _ = dec(bp["attn"], c, norm(cfg.norm, bp["norm1"], h), pos,
                         cfg, layer_kind=kind, long_mode=long_mode)
            h = h + out
            # the MoE runs on the step's B tokens (the capacity path's C
            # from T = B, dropping included); its aux is dropped
            out, _ = _ffn(bp, norm(cfg.norm, bp["norm2"], h), cfg)
            h = h + out
    return _head(params, h, cfg), caches


def prefill(params, tokens, cfg: ModelConfig, *, frontend_embeds=None,
            max_len: int | None = None, tp=None):
    """Forward pass + cache construction for the decode that follows.

    Returns (last-position logits (B,1,V), caches, aux).  The caches are
    each block's post-rope K/V, MLA latents or final SSM state from the
    forward pass, so ``decode_step`` continues exactly; ``max_len`` pads
    the linear caches with decode headroom.  ``aux`` holds the MoE's
    router losses (zeros for the dense family).  Over a model axis ``tp``
    of size > 1, ``params`` is the list of the local shards' trees and the
    caches are one tree per shard."""
    if _sharded(tp):
        from . import tensor_parallel
        return tensor_parallel.prefill(params, tokens, cfg, tp,
                                       frontend_embeds=frontend_embeds,
                                       max_len=max_len)
    logits, aux, caches = _forward(params, tokens, cfg,
                                   frontend_embeds=frontend_embeds,
                                   want_cache=True)
    if max_len is not None:
        caches = _pad_caches(caches, tokens.shape[1], max_len)
    return logits[:, -1:], caches, aux


def _pad_caches(caches, cur_len: int, max_len: int):
    """Pad the full-length (linear) KV and MLA caches along the position
    axis with zeros to ``max_len``; SSM caches have no position axis.
    Leaves are stacked over the units: ``(n_units, B, L, ...)``.  A cache
    whose length is not ``cur_len`` is a ring (L == window < cur_len) and
    is left alone: decode masks by age."""
    def pad(x):
        L = x.shape[2]
        if L != cur_len or max_len <= L:
            return x
        out = x.new_zeros(x.shape[:2] + (max_len,) + x.shape[3:])
        out[:, :, :L] = x
        return out

    def walk(c):
        if isinstance(c, attn.KVCache):
            return attn.KVCache(k=pad(c.k), v=pad(c.v))
        if isinstance(c, attn.MLACache):
            return attn.MLACache(c_kv=pad(c.c_kv), k_rope=pad(c.k_rope))
        if isinstance(c, ssm_lib.SSMCache):
            return c
        if isinstance(c, dict):
            return {k: walk(v) for k, v in c.items()}
        raise TypeError(type(c))

    return walk(caches)
