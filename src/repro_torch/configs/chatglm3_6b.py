"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    attention="full",
    rope="standard",
    rotary_pct=0.5,          # GLM applies rotary to half the head dims
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="swiglu",
    qkv_bias=True,
    window=8192,             # used only by the long_500k substitution
    long_context="sliding_window",
    source="arXiv:2406.12793 (ChatGLM family; GLM 2D/partial rotary, GQA kv=2)",
)
