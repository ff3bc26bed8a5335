"""Plain PyTorch reference of a dense decoder with grouped-query attention
(chatglm3-6b's family): its parameter layout, forward pass and next-token
loss, written from the published description and independent of the
program under test.

Numerics follow the configuration: parameters float32, products in the
compute dtype (bf16) against weights cast at use, norms and softmax in
float32, attention scores and the value product in float32 over bf16
operands, the probabilities rounded to bf16 before the value product,
logits float32.  Attention is computed whole per sequence (no query
chunks); the causal mask is applied to float32 scores.

``Precision`` decides how a projection multiplies: ``"bf16"`` as the
configuration states, or ``"fp8"``, the operands rounded to float8 e4m3
with one scale per tensor (the control of the correctness check).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30
# the widths at which the CPU tests drive this family (the configuration's
# keys they replace)
TINY = dict(d_model=16, n_heads=2, n_kv_heads=1, head_dim=8, d_ff=16,
            vocab_size=32)

# ---------------------------------------------------------------- layout --

def _linear(name, d_in, d_out, bias=False):
    out = [((name, "w"), (d_in, d_out), "matrix")]
    if bias:
        out.append(((name, "b"), (d_out,), "zeros"))
    return out


def _norm(name, d):
    return [((name, "scale"), (d,), "ones")]


def attention_layout(cfg):
    d, H, KH, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    bias = cfg.get("qkv_bias", False)
    return (_linear("wq", d, H * hd, bias) + _linear("wk", d, KH * hd, bias)
            + _linear("wv", d, KH * hd, bias) + _linear("wo", H * hd, d))


def layout(cfg, attention_layout=attention_layout):
    """[(path, shape, init)] of every parameter leaf, sorted by path.
    Layers are stacked on a leading dim of ``n_layers``; ``init`` is
    ``matrix`` (normal times d_in ** -0.5), ``embedding`` (normal times
    d ** -0.5), ``ones`` or ``zeros``."""
    d, L = cfg["d_model"], cfg["n_layers"]
    layer = (_norm("norm1", d)
             + [(("attn",) + p, s, i) for p, s, i in attention_layout(cfg)]
             + _norm("norm2", d)
             + [(("mlp",) + p, s, i) for p, s, i in
                _linear("gate", d, cfg["d_ff"]) + _linear("up", d, cfg["d_ff"])
                + _linear("down", cfg["d_ff"], d)])
    out = [(("embed", "table"), (cfg["vocab_size"], d), "embedding"),
           (("final_norm", "scale"), (d,), "ones"),
           (("lm_head", "w"), (d, cfg["vocab_size"]), "matrix")]
    out += [(("units", "b0") + p, (L,) + s, i) for p, s, i in layer]
    return sorted(out)


def init_scale(shape, init):
    """The factor a standard normal draw is multiplied by (0 for a
    constant leaf)."""
    if init == "matrix":
        return shape[-2] ** -0.5
    if init == "embedding":
        return shape[-1] ** -0.5
    return 0.0


def layer_params(params, i):
    """Layer ``i``'s leaves: ``{path below units.b0: tensor}``."""
    return {p[2:]: t[i] for p, t in params.items() if p[:2] == ("units", "b0")}


# ------------------------------------------------------------- numerics --

class Precision:
    """How a projection's operands are rounded before the product:
    ``bf16`` (the configuration's compute dtype) or ``fp8`` (e4m3, one
    scale per tensor, amax mapped to 448; the product then runs on the
    rounded values in bf16, and the backward takes the rounding as the
    identity)."""

    def __init__(self, kind: str = "bf16"):
        if kind not in ("bf16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def _round(self, x):
        if self.kind == "bf16":
            return x.to(torch.bfloat16)
        xf = x.float()
        with torch.no_grad():
            scale = xf.abs().amax().clamp(min=1e-30) / 448.0
            q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
        # the rounding passes the gradient through unchanged
        return (xf + (q - xf).detach()).to(torch.bfloat16)

    def matmul(self, x, w):
        return self._round(x) @ self._round(w)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def linear(prec, p, x):
    y = prec.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def sub(params, name):
    """The leaves under ``name`` as a dict of their last key."""
    return {k[-1]: v for k, v in params.items() if k[:-1] == (name,)}


def rope_tables(positions, dim: int, theta: float):
    """cos and sin (S, dim), each frequency repeated for its pair of
    interleaved dims; frequencies in float64 rounded to float32."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    ang = positions.float()[:, None] * torch.from_numpy(
        inv.astype(np.float32)).to(positions.device)
    return (torch.repeat_interleave(torch.cos(ang), 2, dim=-1),
            torch.repeat_interleave(torch.sin(ang), 2, dim=-1))


def rotate(x, cos, sin):
    """Rotary embedding of interleaved pairs (x0, x1) -> (x0 c - x1 s,
    x1 c + x0 s) over x (B, S, H, dim), in float32, rounded back to x's
    dtype."""
    pair = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return (x * cos[None, :, None] + pair * sin[None, :, None]).to(x.dtype)


def causal_attention(q, k, v, scale, dtype):
    """q (B,S,H,dq), k (B,S,H,dq), v (B,S,H,dv), float32, every head with
    its own K and V: float32 scores and softmax, the probabilities rounded
    to ``dtype`` before the value product; (B,S,H*dv) float32."""
    B, S, H, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).float(), v)
    return out.reshape(B, S, -1)


def attention(prec, p, x, cfg):
    B, S, _ = x.shape
    H, KH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = linear(prec, sub(p, "wq"), x).reshape(B, S, H, hd)
    k = linear(prec, sub(p, "wk"), x).reshape(B, S, KH, hd)
    v = linear(prec, sub(p, "wv"), x).reshape(B, S, KH, hd)
    rd = int(hd * cfg.get("rotary_pct", 1.0))
    rd -= rd % 2
    cos, sin = rope_tables(torch.arange(S, device=x.device), rd,
                           cfg["rope_theta"])
    q = torch.cat([rotate(q[..., :rd], cos, sin), q[..., rd:]], dim=-1)
    k = torch.cat([rotate(k[..., :rd], cos, sin), k[..., rd:]], dim=-1)
    # query head h reads KV head h // (H / KH); K and V are shared in
    # float32, so their gradients over the group add in float32
    k = k.float().repeat_interleave(H // KH, dim=2)
    v = v.float().repeat_interleave(H // KH, dim=2)
    out = causal_attention(q.float(), k, v, hd ** -0.5, x.dtype)
    return linear(prec, sub(p, "wo"), out.to(x.dtype))


def mlp(prec, p, x):
    m = {k[1:]: v for k, v in p.items() if k[0] == "mlp"}
    gate = linear(prec, sub(m, "gate"), x)
    up = linear(prec, sub(m, "up"), x)
    return linear(prec, sub(m, "down"), F.silu(gate) * up)


def forward(params, tokens, cfg, prec, attention=attention):
    """Logits (B, S, V) float32 of tokens (B, S)."""
    cdt = getattr(torch, cfg["compute_dtype"])
    h = F.embedding(tokens.long(), params[("embed", "table")]).to(cdt)
    for i in range(cfg["n_layers"]):
        lp = layer_params(params, i)
        a = {k[1:]: v for k, v in lp.items() if k[0] == "attn"}
        h = h + attention(prec, a, rmsnorm(h, lp[("norm1", "scale")]), cfg)
        h = h + mlp(prec, lp, rmsnorm(h, lp[("norm2", "scale")]))
    h = rmsnorm(h, params[("final_norm", "scale")])
    return linear(prec, {"w": params[("lm_head", "w")]}, h).float()


def loss(params, tokens, cfg, prec, attention=attention):
    """Mean next-token cross entropy over the batch."""
    logits = forward(params, tokens, cfg, prec, attention)[:, :-1]
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - logits.gather(-1, tgt[..., None])[..., 0]).mean()


def loss_and_grads(params, tokens, cfg, prec, attention=attention,
                   rows_at_once: int | None = None):
    """(mean loss, {path: float32 gradient}) over the rows of ``tokens``,
    ``rows_at_once`` rows a pass (all by default): every pass's loss and
    gradients weighted by its share of the rows, so the result is that of
    the whole batch."""
    B = tokens.shape[0]
    n = rows_at_once or B
    paths = sorted(params)
    leaves = [params[p].detach().requires_grad_() for p in paths]
    live = dict(zip(paths, leaves))
    total, grads = 0.0, None
    for start in range(0, B, n):
        part = tokens[start:start + n]
        w = part.shape[0] / B
        value = loss(live, part, cfg, prec, attention)
        gs = torch.autograd.grad(value * w, leaves)
        total += float(value.detach()) * w
        grads = list(gs) if grads is None else [a + b for a, b in zip(grads, gs)]
    return total, dict(zip(paths, grads))
