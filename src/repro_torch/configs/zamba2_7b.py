"""zamba2-7b — hybrid: a Mamba2 stack and one shared attention block
(arXiv:2411.15242).

81 Mamba2 layers; one *shared* (weight-tied) attention+MLP block runs after
every ``shared_attn_interval`` layers (Zamba2's global shared transformer
block).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,          # shared block is MHA
    d_ff=14336,             # shared block FFN
    vocab_size=32_000,
    head_dim=112,
    activation="gelu",
    ssm_state=64,
    ssm_head_dim=64,        # d_inner = 7168 -> 112 SSD heads
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv_kernel=4,
    ssm_chunk=64,
    shared_attn_interval=6,
)
