"""Model assembly: decoder-only LM over a stack of GQA transformer blocks
(PyTorch port of ``repro.models.model``).

The parameters are the reference's nested dict, key for key: ``embed``,
``final_norm``, ``lm_head`` (when not tied) and ``units.b{i}.…``, each
unit leaf stacked over the units on a leading dim.  ``forward`` walks the
units in a Python loop, each reading its slice of the stacked leaves (the
reference's ``lax.scan``).  A block's FFN is the dense MLP or, when
``cfg.moe`` is set, the MoE (``models.moe``), whose router aux losses are
averaged over the layers.  The MLA, SSM and hybrid blocks and the modality
frontends are not ported yet.

Three entry points per architecture x input shape:
  forward / loss_fn  -- training shapes
  prefill            -- forward + KV cache construction
  decode_step        -- one token against the caches (the serve step),
                        which it updates in place
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import attention as attn
from . import moe as moe_lib
from .config import ModelConfig
from .layers import (Init, embed, embedding_init, linear, linear_init, mlp,
                     mlp_init, norm, norm_init, unembed)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 3); the port's "
        f"model runs the dense GQA and MoE families")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention == "mla":
        raise _not_ported("MLA attention")
    if cfg.arch_type in ("ssm", "hybrid"):
        raise _not_ported("the Mamba2/SSD block")


# ------------------------------------------------------------------- init --

def _block_init(init: Init, cfg: ModelConfig):
    p = {
        "norm1": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
        "attn": attn.gqa_init(init, cfg),
        "norm2": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_init(init, cfg)
    else:
        p["mlp"] = mlp_init(init, cfg.d_model, cfg.d_ff,
                            activation=cfg.activation, dtype=cfg.pdtype)
    return p


def _init(init: Init, cfg: ModelConfig):
    _check_supported(cfg)
    pattern, n_units = cfg.unit_pattern()
    params: dict = {
        "embed": embedding_init(init, cfg.vocab_size, cfg.d_model,
                                dtype=cfg.pdtype),
        "final_norm": norm_init(init, cfg.norm, cfg.d_model,
                                dtype=cfg.pdtype),
    }
    units = init.stacked(n_units)
    params["units"] = {f"b{i}": _block_init(units, cfg)
                       for i in range(len(pattern))}
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


def _apply_block(bp, h, positions, cfg: ModelConfig, kind: str, *,
                 want_cache: bool = False):
    """One block: (h, its aux losses or None, the layer's KVCache or
    None)."""
    out = attn.gqa_forward(bp["attn"], norm(cfg.norm, bp["norm1"], h),
                           positions, cfg, layer_kind=kind,
                           return_kv=want_cache)
    cache = None
    if want_cache:
        out, cache = out
    h = h + out
    out, aux = _ffn(bp, norm(cfg.norm, bp["norm2"], h), cfg)
    return h + out, aux, cache


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
    the dense family), as the reference's ``forward`` returns them."""
    _check_supported(cfg)
    if frontend_embeds is not None:
        raise _not_ported("the modality frontends")
    pattern, n_units = cfg.unit_pattern()
    B, S = tokens.shape
    h = embed(params["embed"], tokens).to(cfg.cdtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    if cfg.rope == "none":
        h = h + _sinusoidal(cfg.d_model, positions).to(h.dtype)

    def unit_fn(h, lb, rz, unit_params):
        caches = {}
        for i, kind in enumerate(pattern):
            h, aux, caches[f"b{i}"] = _apply_block(
                unit_params[f"b{i}"], h, positions, cfg, kind,
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
    return logits, aux, {
        key: attn.KVCache(k=torch.stack([c[key].k for c in unit_caches]),
                          v=torch.stack([c[key].v for c in unit_caches]))
        for key in unit_caches[0]}


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


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """batch: {"tokens": (B,S)}.  Next-token cross entropy (+ the MoE's
    aux losses, weighted by ``router_aux_weight``).  Returns (loss,
    metrics): ``nll``, ``load_balance`` and ``router_z`` (zeros for the
    dense family), as the reference's."""
    tokens = batch["tokens"]
    logits, aux, _ = _forward(params, tokens, cfg,
                              frontend_embeds=batch.get("frontend_embeds"),
                              remat=remat)
    tgt = tokens[:, 1:].to(torch.int64)
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    # the target logit by a gather: the reference's one-hot sum has the
    # same value for finite logits
    tgt_logit = torch.gather(lg, -1, tgt[..., None])[..., 0]
    nll = torch.mean(lse - tgt_logit)
    loss = nll
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * (
            aux["load_balance"] + aux["router_z"])
    return loss, {"nll": nll, **aux}


# ------------------------------------------------------------ serve paths --

def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                long_mode: bool = False, device=None):
    """Zero caches, one :class:`~repro_torch.models.attention.KVCache` a
    block of the unit pattern, each leaf stacked over the units:
    ``(n_units, batch, L, KH, hd)`` on ``device`` (None = the card;
    ``"meta"`` for shapes only).  The reference broadcasts one unit's
    zeros; these are allocated whole, since decode writes them in
    place."""
    _check_supported(cfg)
    device = resolve_device(device)
    pattern, n_units = cfg.unit_pattern()
    return {f"b{i}": attn.gqa_init_cache(cfg, batch, seq_len,
                                         layer_kind=kind,
                                         long_mode=long_mode,
                                         lead=(n_units,), device=device)
            for i, kind in enumerate(pattern)}


def decode_step(params, caches, token, pos, cfg: ModelConfig, *,
                long_mode: bool = False):
    """The serve step: one new token per sequence against the caches.

    token: (B, 1) int; pos: the current position, a Python int.  Writes
    each layer's K/V into ``caches`` in place and returns (logits
    (B, 1, V) float32, caches)."""
    _check_supported(cfg)
    pattern, n_units = cfg.unit_pattern()
    B = token.shape[0]
    h = embed(params["embed"], token).to(cfg.cdtype)
    if cfg.rope == "none":
        p = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
        h = h + _sinusoidal(cfg.d_model, p).to(h.dtype)
    for u, unit_params in enumerate(_unit_slices(params["units"], n_units)):
        for i, kind in enumerate(pattern):
            bp, c = unit_params[f"b{i}"], caches[f"b{i}"]
            # the unit's views of the stacked cache, written in place
            out, _ = attn.gqa_decode(
                bp["attn"], attn.KVCache(k=c.k[u], v=c.v[u]),
                norm(cfg.norm, bp["norm1"], h), pos, cfg, layer_kind=kind,
                long_mode=long_mode)
            h = h + out
            # the MoE runs on the step's B tokens (the capacity path's C
            # from T = B, dropping included); its aux is dropped
            out, _ = _ffn(bp, norm(cfg.norm, bp["norm2"], h), cfg)
            h = h + out
    return _head(params, h, cfg), caches


def prefill(params, tokens, cfg: ModelConfig, *, frontend_embeds=None,
            max_len: int | None = None):
    """Forward pass + cache construction for the decode that follows.

    Returns (last-position logits (B,1,V), caches, aux).  The caches are
    each block's post-rope K/V from the forward pass, so ``decode_step``
    continues exactly; ``max_len`` pads the linear caches with decode
    headroom.  ``aux`` holds the MoE's router losses (zeros for the dense
    family)."""
    logits, aux, caches = _forward(params, tokens, cfg,
                                   frontend_embeds=frontend_embeds,
                                   want_cache=True)
    if max_len is not None:
        caches = _pad_caches(caches, tokens.shape[1], max_len)
    return logits[:, -1:], caches, aux


def _pad_caches(caches, cur_len: int, max_len: int):
    """Pad the full-length (linear) caches along the position axis with
    zeros to ``max_len``.  Leaves are stacked over the units:
    ``(n_units, B, L, ...)``.  A cache whose length is not ``cur_len`` is a
    ring (L == window < cur_len) and is left alone: decode masks by age."""
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
        if isinstance(c, dict):
            return {k: walk(v) for k, v in c.items()}
        raise TypeError(type(c))

    return walk(caches)
