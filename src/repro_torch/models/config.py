"""Architecture configuration schema (PyTorch port of
``repro.models.config``).

One ``ModelConfig`` describes any architecture in the assigned pool: dense
GQA transformers, MLA, MoE, Mamba2/SSD, hybrids, and modality-stub decoders.
``repro_torch/configs/<arch>.py`` instantiate these with the exact assigned
hyperparameters; ``reduced()`` derives the CPU smoke-test variant.  The
schema is the reference's field for field; ``pdtype``/``cdtype`` are torch
dtypes.  The port's model runs the dense GQA and MoE families
(``models/model.py``).

Fields past the reference's default to the reference's behaviour:
``RopeScaling`` (YaRN), ``MLAConfig.q_lora_rank = None`` (a query
without a latent), the held-expert, shared-expert and balance fields of
``MoEConfig`` and ``first_k_dense_replace`` (DeepSeek-V2's families).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    impl: Literal["dense", "capacity", "dropless"] = "capacity"
    router_aux_weight: float = 0.01
    # the router's outputs when this layer holds only some of the experts
    # (expert parallelism): it holds [first_expert, first_expert +
    # n_experts) of n_router (None: all n_experts, from 0)
    n_router: int | None = None
    first_expert: int = 0
    n_shared: int = 0              # shared experts: one MLP n_shared * d_expert wide
    norm_topk: bool = True         # renormalise the top-k weights
    # the balance loss: Switch's load balance plus the z-loss, or
    # DeepSeek-V2's sequence-wise loss alone, summed over the layers
    balance: Literal["switch", "sequence"] = "switch"

    @property
    def router_width(self) -> int:
        return self.n_router or self.n_experts


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int | None = 768    # None: the query without a latent
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64
    absorb: bool = False           # absorbed decode matmuls (§Perf)


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN (arXiv:2309.00071) as DeepSeek-V2 configures it, under its
    ``rope_scaling`` keys."""
    type: Literal["yarn"]
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None            # default d_model // n_heads
    # attention pattern
    attention: Literal["full", "sliding", "local_global", "mla", "none"] = "full"
    window: int = 4096                     # sliding-window length
    local_global_ratio: int = 5            # N local layers per 1 global
    # positions
    rope: Literal["standard", "partial", "mrope", "none"] = "standard"
    rope_theta: float = 10000.0
    rope_theta_local: float | None = None  # gemma3: separate local theta
    rotary_pct: float = 1.0                # partial rotary fraction (chatglm)
    rope_scaling: RopeScaling | None = None
    # blocks
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["swiglu", "geglu", "gelu", "silu"] = "swiglu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    first_k_dense_replace: int = 0         # leading dense layers before the MoE
    attn_every: int = 0                    # hybrid: shared attn every N layers
    shared_attention: bool = False         # hybrid: attn params shared
    # modality stub
    frontend: Literal["none", "vision", "audio"] = "none"
    frontend_tokens: int = 0               # stub embedding positions
    # long-context substitution (DESIGN.md §4)
    long_context: Literal["native", "sliding_window"] = "native"
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # §Perf knob: constrain inter-block activations to stay model-sharded on
    # d_model (GSPMD then reshards with gather/reduce-scatter pairs around
    # each block instead of keeping replicated activations)
    activation_sharding: bool = False
    # citation
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'attn_global' | 'attn_local' |
        'mamba' | 'mamba_attn' (hybrid layer with shared attention)."""
        kinds = []
        for i in range(self.n_layers):
            if self.arch_type == "ssm":
                kinds.append("mamba")
            elif self.arch_type == "hybrid":
                if self.attn_every and (i + 1) % self.attn_every == 0:
                    kinds.append("mamba_attn")
                else:
                    kinds.append("mamba")
            elif self.attention == "local_global":
                r = self.local_global_ratio
                kinds.append("attn_global" if (i + 1) % (r + 1) == 0
                             else "attn_local")
            else:
                kinds.append("attn")
        return kinds

    def unit_pattern(self) -> tuple[list[str], int]:
        """(pattern, n_units): the layers after the leading dense ones =
        pattern * n_units; scan over units."""
        kinds = self.layer_kinds()[self.first_k_dense_replace:]
        # find the smallest repeating pattern that tiles the layer list
        for plen in range(1, len(kinds) + 1):
            if len(kinds) % plen:
                continue
            if kinds == kinds[: plen] * (len(kinds) // plen):
                return kinds[: plen], len(kinds) // plen
        return kinds, 1

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            if kind.startswith("attn"):
                per = self._attn_params() + self._ffn_params(
                    dense=i < self.first_k_dense_replace)
            elif kind == "mamba":
                per = self._mamba_params()
            elif kind == "mamba_attn":
                per = self._mamba_params()
            per_layer += per + 2 * d  # norms
        n += per_layer
        if self.shared_attention and self.arch_type == "hybrid":
            n += self._attn_params() + self._ffn_params() + 2 * self.d_model
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.attention == "mla":
            m = self.mla
            qd = m.qk_nope_head_dim + m.qk_rope_head_dim
            q = (d * self.n_heads * qd if m.q_lora_rank is None else
                 d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qd)
            return (q + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def _ffn_params(self, dense: bool = False) -> int:
        d = self.d_model
        gates = 3 if self.activation in ("swiglu", "geglu") else 2
        if self.moe is not None and not dense:
            e = self.moe
            return (d * e.router_width + e.n_experts * gates * d * e.d_expert
                    + gates * d * e.n_shared * e.d_expert)
        return gates * d * self.d_ff

    def _mamba_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_in = s.expand * d
        nh = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        return (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
                + conv_dim * s.d_conv + nh + nh + d_in            # conv,A,D,nrm
                + d_in * d)                                       # out_proj

    def reduced(self, *, n_layers=2, d_model=256, n_experts=4,
                vocab=512, d_ff=None) -> "ModelConfig":
        """CPU smoke-test variant of the same family."""
        heads = max(2, min(self.n_heads, d_model // 64))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes: dict = dict(
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            d_ff=d_ff or (2 * d_model if self.d_ff else 0),
            vocab_size=vocab,
            head_dim=64,
            window=min(self.window, 64),
            frontend_tokens=min(self.frontend_tokens, 16),
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=n_experts,
                top_k=min(self.moe.top_k, n_experts),
                d_expert=2 * d_model, impl="dense")
        if self.mla is not None:
            changes["mla"] = dataclasses.replace(
                self.mla, q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=16)
        if self.arch_type == "hybrid":
            changes["attn_every"] = 2
            changes["n_layers"] = 4
        if self.attention == "local_global":
            changes["local_global_ratio"] = 1
            changes["n_layers"] = 4
        return dataclasses.replace(self, **changes)
