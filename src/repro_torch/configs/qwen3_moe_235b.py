"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3 family; hf] — MoE 128 experts top-8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,              # per-expert intermediate size
    vocab_size=151_936,
    head_dim=128,
    activation="silu",
    n_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
)
