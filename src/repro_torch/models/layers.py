"""Basic NN layers: norms, projections, gated MLPs, embeddings (PyTorch
port of ``repro.models.layers``).

Parameters are plain nested dicts of tensors and every layer is a pure
function of them, so the whole model stays a tree that the exchange
sparsifies leaf by leaf.  Each ``*_init`` takes an :class:`Init`, which
draws every leaf from one seeded ``torch.Generator`` on the target device
(not the reference's ``jax.random`` bits: tests carry the reference's
parameters across with ``convert.params_from_numpy``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Init:
    """Makes parameter leaves of shape ``lead + shape`` on ``device``, the
    random ones from ``gen`` (a ``torch.Generator`` on that device), in
    the order they are asked for.  With ``gen=None`` the leaves are meta
    tensors: shapes and dtypes, no storage."""

    def __init__(self, gen: torch.Generator | None, device, lead=()):
        self.gen, self.device, self.lead = gen, torch.device(device), lead

    def stacked(self, n: int) -> "Init":
        """The same draws, every leaf with a leading dim ``n`` more (the
        model's units, stacked)."""
        return Init(self.gen, self.device, (n,) + self.lead)

    def _empty(self, shape, dtype):
        return torch.empty(self.lead + tuple(shape), dtype=dtype,
                           device="meta" if self.gen is None else self.device)

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        """``scale`` times a standard normal truncated to [-2, 2] (by the
        inverse CDF, as ``jax.random.truncated_normal``)."""
        out = self._empty(shape, torch.float32)
        if self.gen is None:
            return out.to(dtype)
        lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
        u = torch.rand(out.shape, generator=self.gen, device=self.device)
        x = torch.erfinv(u.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0))
        return x.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale).to(dtype)

    def ones(self, shape, dtype) -> torch.Tensor:
        out = self._empty(shape, dtype)
        return out if self.gen is None else out.fill_(1.0)

    def zeros(self, shape, dtype) -> torch.Tensor:
        out = self._empty(shape, dtype)
        return out if self.gen is None else out.zero_()


# ----------------------------------------------------------------- linear --

def linear_init(init: Init, d_in: int, d_out: int, *, dtype=torch.float32,
                bias: bool = False):
    p = {"w": init.normal((d_in, d_out), d_in ** -0.5, dtype)}
    if bias:
        p["b"] = init.zeros((d_out,), dtype)
    return p


def linear(p, x):
    """Matmul in the activation dtype (params cast at use: bf16 compute
    against f32 master weights, the standard mixed-precision recipe)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ------------------------------------------------------------------ norms --

def norm_init(init: Init, kind: str, d: int, *, dtype=torch.float32):
    p = {"scale": init.ones((d,), dtype)}
    if kind != "rmsnorm":
        p["bias"] = init.zeros((d,), dtype)
    return p


def rmsnorm(p, x, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm(p, x, *, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def norm(kind: str, p, x):
    return (rmsnorm if kind == "rmsnorm" else layernorm)(p, x)


# ------------------------------------------------------------------- mlps --

def mlp_init(init: Init, d_model: int, d_ff: int, *,
             activation: str = "swiglu", dtype=torch.float32):
    p = {"up": linear_init(init, d_model, d_ff, dtype=dtype),
         "down": linear_init(init, d_ff, d_model, dtype=dtype)}
    if activation in ("swiglu", "geglu"):
        p["gate"] = linear_init(init, d_model, d_ff, dtype=dtype)
    return p


def mlp(p, x, *, activation: str = "swiglu"):
    # jax.nn.gelu is the tanh approximation by default
    if activation == "swiglu":
        h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
    elif activation == "geglu":
        h = F.gelu(linear(p["gate"], x), approximate="tanh") \
            * linear(p["up"], x)
    elif activation == "gelu":
        h = F.gelu(linear(p["up"], x), approximate="tanh")
    elif activation == "silu":
        h = F.silu(linear(p["up"], x))
    else:
        raise ValueError(activation)
    return linear(p["down"], h)


# -------------------------------------------------------------- embedding --

def embedding_init(init: Init, vocab: int, d_model: int, *,
                   dtype=torch.float32):
    # d^-0.5 keeps tied-head logits O(1)
    return {"table": init.normal((vocab, d_model), d_model ** -0.5, dtype)}


def embed(p, tokens):
    return F.embedding(tokens.to(torch.int64), p["table"])


def unembed(p, x):
    """Tied LM head: logits = x @ table.T (float32 for stable softmax)."""
    return x.to(torch.float32) @ p["table"].to(torch.float32).T
