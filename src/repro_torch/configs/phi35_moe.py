"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf] — MoE 16e top-2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,              # per-expert intermediate size
    vocab_size=32_064,
    head_dim=128,
    activation="silu",
    n_experts=16,
    experts_per_token=2,
    rope_theta=10_000.0,
)
