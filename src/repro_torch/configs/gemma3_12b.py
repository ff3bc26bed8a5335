"""gemma3-12b [dense] — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    attention="local_global",
    local_global_ratio=5,     # 5 sliding-window layers per global layer
    window=1024,
    rope="standard",
    rope_theta=1_000_000.0,   # global layers
    rope_theta_local=10_000.0,
    norm="rmsnorm",
    activation="geglu",
    tie_embeddings=True,
    long_context="native",    # 40/48 layers are windowed already
    source="hf:google/gemma-3-1b-pt scaled per gemma-3-12b card",
)
