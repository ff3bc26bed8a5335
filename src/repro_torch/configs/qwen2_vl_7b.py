"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution; vision tower is a stub
that supplies patch embeddings (assignment carve-out) [arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    attention="full",
    rope="mrope",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    activation="swiglu",
    qkv_bias=True,
    frontend="vision",
    frontend_tokens=1024,     # stub: 32x32 patch grid per sequence
    window=8192,
    long_context="sliding_window",
    source="arXiv:2409.12191 (Qwen2-VL-7B)",
)
