"""Model assembly: decoder-only LM over a stack of GQA transformer blocks
(PyTorch port of the training path of ``repro.models.model``).

The parameters are the reference's nested dict, key for key: ``embed``,
``final_norm``, ``lm_head`` (when not tied) and ``units.b{i}.…``, each
unit leaf stacked over the units on a leading dim.  ``forward`` walks the
units in a Python loop, each reading its slice of the stacked leaves (the
reference's ``lax.scan``).  The MoE, MLA, SSM and hybrid blocks, the
modality frontends, prefill and decode are not ported yet.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import attention as attn
from .config import ModelConfig
from .layers import (Init, embed, embedding_init, linear, linear_init, mlp,
                     mlp_init, norm, norm_init, unembed)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 4); the port's "
        f"model runs the dense GQA family")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise _not_ported("the MoE block")
    if cfg.attention == "mla":
        raise _not_ported("MLA attention")
    if cfg.arch_type in ("ssm", "hybrid"):
        raise _not_ported("the Mamba2/SSD block")


# ------------------------------------------------------------------- init --

def _block_init(init: Init, cfg: ModelConfig):
    return {
        "norm1": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
        "attn": attn.gqa_init(init, cfg),
        "norm2": norm_init(init, cfg.norm, cfg.d_model, dtype=cfg.pdtype),
        "mlp": mlp_init(init, cfg.d_model, cfg.d_ff,
                        activation=cfg.activation, dtype=cfg.pdtype),
    }


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

def _apply_block(bp, h, positions, cfg: ModelConfig, kind: str):
    h = h + attn.gqa_forward(bp["attn"], norm(cfg.norm, bp["norm1"], h),
                             positions, cfg, layer_kind=kind)
    hn = norm(cfg.norm, bp["norm2"], h)
    return h + mlp(bp["mlp"], hn, activation=cfg.activation)


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


def forward(params, tokens, cfg: ModelConfig, *, frontend_embeds=None,
            remat: bool = False):
    """tokens: (B, S) int -> logits (B, S, V) float32.

    ``remat=True`` checkpoints each unit (activation recomputation in the
    backward pass)."""
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

    def unit_fn(h, unit_params):
        for i, kind in enumerate(pattern):
            h = _apply_block(unit_params[f"b{i}"], h, positions, cfg, kind)
        return h

    for unit_params in _unit_slices(params["units"], n_units):
        if remat:
            h = checkpoint(unit_fn, h, unit_params, use_reentrant=False)
        else:
            h = unit_fn(h, unit_params)
    h = norm(cfg.norm, params["final_norm"], h)
    if cfg.tie_embeddings:
        return unembed(params["embed"], h)
    return linear(params["lm_head"], h).to(torch.float32)


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """batch: {"tokens": (B,S)}.  Next-token cross entropy.  Returns
    (loss, metrics)."""
    tokens = batch["tokens"]
    logits = forward(params, tokens, cfg,
                     frontend_embeds=batch.get("frontend_embeds"),
                     remat=remat)
    tgt = tokens[:, 1:].to(torch.int64)
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    # the target logit by a gather: the reference's one-hot sum has the
    # same value for finite logits
    tgt_logit = torch.gather(lg, -1, tgt[..., None])[..., 0]
    nll = lse - tgt_logit
    loss = torch.mean(nll)
    return loss, {"nll": loss}
