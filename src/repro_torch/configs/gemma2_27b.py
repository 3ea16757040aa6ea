"""gemma2-27b [arXiv:2408.00118; hf] — local+global alternating, logit softcap."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256_000,
    head_dim=128,
    activation="gelu",          # GeGLU
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern="alt_local_global",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
