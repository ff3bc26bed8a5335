"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, fine-grained
[hf:Qwen/Qwen3-30B-A3B scaled per Qwen3-235B-A22B card]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                # per-expert (fine-grained experts)
    vocab_size=151936,
    head_dim=128,
    attention="full",
    rope="standard",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                  capacity_factor=1.25, impl="capacity"),
    window=8192,
    long_context="sliding_window",
    source="hf:Qwen/Qwen3-30B-A3B (235B-A22B geometry)",
)
