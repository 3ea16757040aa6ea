"""llada-8b — the paper's own evaluation model (LLaDA-8B-Instruct).

Llama-2-like backbone with bidirectional attention and a mask-predict head;
vocab 126,464 as in the paper's §3.2 logit-boom arithmetic.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llada-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=12288,
    vocab_size=126_464,
    head_dim=128,
    activation="silu",
    rope_theta=500_000.0,
)
