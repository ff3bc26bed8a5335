"""Mamba2 block, SSD (state-space duality) form, arXiv:2405.21060 (PyTorch
port of ``repro.models.ssm``).

Training and prefill run the chunked SSD algorithm: within a chunk of
length Q the recurrence is a masked (semiseparable) matmul, and the chunks
are chained by a short sequential loop over per-chunk states.  Decode is
the O(1)-per-token recurrent update on a (B, H, P, N) state plus a rolling
conv window, written into the caches in place.

Layout: d_inner = expand * d_model, heads H = d_inner / head_dim (P),
B/C projections per group (n_groups G), state size N = d_state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Init, linear, linear_init, norm_init, rmsnorm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim


def mamba_init(init: Init, cfg: ModelConfig):
    s, d_in, nh, conv_dim = _dims(cfg)
    d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + nh  # z, x, B, C, dt
    # the reference's deterministic decay rates, computed as it does (a
    # float32 linspace, then log)
    a_log = torch.from_numpy(np.log(np.linspace(
        1.0, 16.0, nh, dtype=np.float32)).astype(np.float32))
    A_log = init.zeros((nh,), cfg.pdtype)
    if A_log.device.type != "meta":
        A_log.copy_(a_log.to(cfg.pdtype))
    return {
        "in_proj": linear_init(init, cfg.d_model, d_proj, dtype=cfg.pdtype),
        "conv_w": init.normal((s.d_conv, conv_dim), s.d_conv ** -0.5,
                              cfg.pdtype),
        "conv_b": init.zeros((conv_dim,), cfg.pdtype),
        "dt_bias": init.zeros((nh,), cfg.pdtype),
        "A_log": A_log,
        "D": init.ones((nh,), cfg.pdtype),
        "norm": norm_init(init, "rmsnorm", d_in, dtype=cfg.pdtype),
        "out_proj": linear_init(init, d_in, cfg.d_model, dtype=cfg.pdtype),
    }


def _split_proj(cfg: ModelConfig, proj):
    s, d_in, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xbc_dt = proj[..., :d_in], proj[..., d_in:]
    return z, xbc_dt[..., :d_in + 2 * gn], xbc_dt[..., d_in + 2 * gn:]


def _causal_conv(xBC, w, b):
    """Depthwise causal conv of width K. xBC: (B,S,C); w: (K,C).

    The K taps are multiplied and added in the activation dtype, in tap
    order, rounding after each add (the reference's Python ``sum``); the
    silu follows a float32 bias add.  Returns float32."""
    K, S = w.shape[0], xBC.shape[1]
    w = w.to(xBC.dtype)
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out.to(torch.float32) + b.to(torch.float32))


def _segsum(dA):
    """dA: (..., Q) -> L (..., Q, Q): L[i,j] = exp(sum_{j<k<=i} dA_k) for
    i >= j, else 0.  The upper triangle is masked before the exp, which
    would otherwise overflow and poison the gradients."""
    Q = dA.shape[-1]
    csum = torch.cumsum(dA, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.exp(torch.where(tril, diff, float("-inf")))


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked SSD scan, float32.

    x:  (B, S, H, P)   inputs (before the dt scaling)
    dt: (B, S, H)      positive step sizes
    A:  (H,)           negative decay rates
    Bm: (B, S, G, N)   input projections (groups broadcast over heads)
    Cm: (B, S, G, N)   output projections
    Returns (y (B, S, H, P), the final state (B, H, P, N)).  The chunk Q
    is the largest divisor of S that is at most ``chunk``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    f32 = torch.float32
    xdt = x.to(f32) * dt[..., None].to(f32)
    dA = dt.to(f32) * A.to(f32)
    xc = xdt.reshape(Bsz, nc, Q, H, P)
    Bh = Bm.reshape(Bsz, nc, Q, G, N).to(f32).repeat_interleave(hpg, dim=3)
    Ch = Cm.reshape(Bsz, nc, Q, G, N).to(f32).repeat_interleave(hpg, dim=3)
    dA_t = dA.reshape(Bsz, nc, Q, H).movedim(-1, 2)            # (B,nc,H,Q)
    L = _segsum(dA_t)                                           # (B,nc,H,Q,Q)
    # intra-chunk (the diagonal blocks)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * L, xc)
    # per-chunk final states: sum_s exp(sum_{s<k<=Q} dA) * B_s x_s
    csum = torch.cumsum(dA_t, dim=-1)                           # (B,nc,H,Q)
    decay_states = torch.exp(csum[..., -1:] - csum)
    states = torch.einsum("bchs,bcshn,bcshp->bchpn", decay_states, Bh, xc)
    # the inter-chunk recurrence, in sequence over the chunks
    chunk_decay = torch.exp(csum[..., -1])                      # (B,nc,H)
    s_prev = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                      # (B,nc,H,P,N)
    # the off-diagonal part: y += C_l . exp(A_cum_l) state_prev
    y_off = torch.einsum("bclhn,bchl,bchpn->bclhp", Ch, torch.exp(csum),
                         prev_states)
    return (y_diag + y_off).reshape(Bsz, S, H, P), s_prev


class SSMCache(NamedTuple):
    state: torch.Tensor     # (..., B, H, P, N) float32 recurrent state
    conv: torch.Tensor      # (..., B, d_conv - 1, conv_dim) pre-conv inputs


def mamba_forward(params, x, cfg: ModelConfig, *, return_state: bool = False,
                  **_):
    """x: (B, S, d_model) -> (B, S, d_model) (and the layer's
    :class:`SSMCache` when ``return_state``: the float32 final state and
    the last ``d_conv - 1`` pre-conv inputs, zero-padded on the left when
    S is shorter)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    Bsz, S, _ = x.shape
    proj = linear(params["in_proj"], x)
    z, xBC_raw, dt = _split_proj(cfg, proj)
    xBC = _causal_conv(xBC_raw, params["conv_w"], params["conv_b"])
    gn = s.n_groups * s.d_state
    xs = xBC[..., :d_in].reshape(Bsz, S, nh, s.head_dim)
    Bm = xBC[..., d_in:d_in + gn].reshape(Bsz, S, s.n_groups, s.d_state)
    Cm = xBC[..., d_in + gn:].reshape(Bsz, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))
    y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk=s.chunk)
    y = y + params["D"].to(torch.float32)[:, None] * xs
    y = y.reshape(Bsz, S, d_in) * F.silu(z.to(torch.float32))
    out = linear(params["out_proj"], rmsnorm(params["norm"], y.to(x.dtype)))
    if not return_state:
        return out
    K = s.d_conv
    tail = xBC_raw[:, S - (K - 1):] if S >= K - 1 else \
        F.pad(xBC_raw, (0, 0, K - 1 - S, 0))
    return out, SSMCache(state=final_state, conv=tail.to(cfg.cdtype))


def mamba_init_cache(cfg: ModelConfig, batch: int, *, lead: tuple = (),
                     device, **_) -> SSMCache:
    """Zero caches of ``lead + (batch, ...)``: the state float32, the conv
    window in the compute dtype; neither depends on the length."""
    s, d_in, nh, conv_dim = _dims(cfg)
    lead = tuple(lead) + (batch,)
    return SSMCache(
        state=torch.zeros(lead + (nh, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (s.d_conv - 1, conv_dim), dtype=cfg.cdtype,
                         device=device))


def mamba_decode(params, cache: SSMCache, x, pos, cfg: ModelConfig, **_):
    """One recurrent step. x: (B, 1, d_model).  The conv runs in float32
    over the rolled window; the new state and window are written into
    ``cache`` in place.  Returns (out (B, 1, d_model), cache)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    Bsz = x.shape[0]
    proj = linear(params["in_proj"], x[:, 0])                   # (B, d_proj)
    z, xBC, dt = _split_proj(cfg, proj)
    hist = torch.cat([cache.conv.to(torch.float32),
                      xBC[:, None].to(torch.float32)], dim=1)   # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", hist,
                            params["conv_w"].to(torch.float32)) \
        + params["conv_b"].to(torch.float32)
    xBC_c = F.silu(conv_out)
    cache.conv.copy_(hist[:, 1:])
    gn = s.n_groups * s.d_state
    xs = xBC_c[..., :d_in].reshape(Bsz, nh, s.head_dim)
    hpg = nh // s.n_groups
    Bh = xBC_c[..., d_in:d_in + gn].reshape(
        Bsz, s.n_groups, s.d_state).repeat_interleave(hpg, dim=1)  # (B,H,N)
    Ch = xBC_c[..., d_in + gn:].reshape(
        Bsz, s.n_groups, s.d_state).repeat_interleave(hpg, dim=1)
    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))
    decay = torch.exp(dt * A)                                   # (B, H)
    state = (cache.state * decay[..., None, None]
             + (dt[..., None] * xs)[..., :, None] * Bh[:, :, None, :])
    cache.state.copy_(state)
    y = (state @ Ch[..., None])[..., 0]                         # (B, H, P)
    y = y + params["D"].to(torch.float32)[:, None] * xs
    y = y.reshape(Bsz, d_in) * F.silu(z.to(torch.float32))
    out = linear(params["out_proj"], rmsnorm(params["norm"], y.to(x.dtype)))
    return out[:, None], cache
