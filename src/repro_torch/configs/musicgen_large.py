"""musicgen-large [audio] — decoder-only over EnCodec tokens; the EnCodec
feature frontend is a stub supplying frame embeddings [arXiv:2306.05284]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,            # MHA
    d_ff=8192,
    vocab_size=2048,          # EnCodec codebook size
    head_dim=64,
    attention="full",
    rope="none",              # sinusoidal absolute positions
    norm="layernorm",
    activation="gelu",
    frontend="audio",
    frontend_tokens=512,      # stub: conditioning frame embeddings
    window=8192,
    long_context="sliding_window",
    source="arXiv:2306.05284 (MusicGen-large)",
)
