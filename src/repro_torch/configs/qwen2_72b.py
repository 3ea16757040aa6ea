"""qwen2-72b [arXiv:2407.10671; hf] — dense GQA(kv=8), QKV bias. Largest dense."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    activation="silu",
    rope_theta=1_000_000.0,
)
