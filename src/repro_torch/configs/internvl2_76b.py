"""internvl2-76b [arXiv:2404.16821; unverified] — InternViT + Llama3-70B backbone.

The InternViT-6B vision frontend is a stub: each request carries
precomputed patch embeddings (``frontend_dim``) for ``frontend_len``
positions, projected into the model width; the 80-layer LM backbone is
real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    head_dim=128,
    activation="silu",
    rope_theta=500_000.0,
    frontend_dim=3200,      # InternViT-6B hidden size (pre-projection)
    frontend_len=256,       # pixel-shuffled visual tokens per tile
)
