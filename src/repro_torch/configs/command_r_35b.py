"""command-r-35b [dense] — GQA kv=8, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    attention="full",
    rope="standard",
    rope_theta=8_000_000.0,
    norm="layernorm",
    activation="swiglu",
    qkv_bias=False,
    tie_embeddings=True,
    window=8192,
    long_context="sliding_window",
    source="hf:CohereForAI/c4ai-command-r-v01",
)
