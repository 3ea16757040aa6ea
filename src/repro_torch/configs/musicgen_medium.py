"""musicgen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

The EnCodec frontend is a stub: each request carries precomputed frame
embeddings of ``frontend_dim`` at ``frontend_len`` positions, projected
into the model width; the backbone (48 layers, MHA) is real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,          # MHA
    d_ff=6144,
    vocab_size=2048,        # EnCodec codebook size
    head_dim=64,
    activation="gelu",
    rope_theta=10_000.0,
    frontend_dim=1536,      # precomputed conditioning frame embeddings
    frontend_len=256,
)
