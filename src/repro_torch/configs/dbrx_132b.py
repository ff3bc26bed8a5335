"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,               # per-expert FFN hidden
    vocab_size=100352,
    head_dim=128,
    attention="full",
    rope="standard",
    rope_theta=500_000.0,
    norm="layernorm",
    activation="swiglu",
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752,
                  capacity_factor=1.25, impl="capacity"),
    window=8192,
    long_context="sliding_window",
    source="hf:databricks/dbrx-base",
)
