"""minicpm3-4b [dense] — MLA (multi-head latent attention) [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,            # MLA: every head reads the shared latent
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64, absorb=False),
    rope="standard",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="swiglu",
    window=8192,
    long_context="sliding_window",
    source="hf:openbmb/MiniCPM3-4B",
)
