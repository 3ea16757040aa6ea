"""mamba2-130m — SSD (state-space duality), attention-free (arXiv:2405.21060)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,        # d_inner = 2*768 = 1536 -> 24 SSD heads
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv_kernel=4,
    ssm_chunk=64,
    tie_embeddings=True,
)
