"""mamba2-780m [ssm] — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,                # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,                   # no FFN: mamba blocks only
    vocab_size=50280,
    attention="none",
    rope="none",
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    long_context="native",    # O(1) recurrent state
    source="arXiv:2405.21060 (Mamba2-780m)",
)
