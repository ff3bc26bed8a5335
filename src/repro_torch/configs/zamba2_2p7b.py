"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,            # shared attention block is MHA
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    attention="full",
    attn_every=6,             # shared attention block every 6 mamba layers
    shared_attention=True,
    rope="standard",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="gelu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    long_context="native",    # SSM state is O(1); shared-attn cache linear
    source="arXiv:2411.15242 (Zamba2)",
)
