"""Shared layer primitives: RMSNorm, RoPE, gated MLPs, per-layer flags.

Conventions as in ``repro.models.layers``: activations ``[..., D]``,
attention heads ``[..., H, dh]``, normalisation and RoPE in float32 and cast
back to the working dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) parameterization keeps init at identity
    return (out * (1.0 + scale.float())).to(dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [..., half] for integer positions [...]."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split (not interleaved) rotation. x: [..., S, H, dh];
    cos/sin: [..., S, half]."""
    dtype = x.dtype
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU / GeGLU. ``gelu`` is the tanh form, which is what
    ``jax.nn.gelu`` computes by default."""
    gate = x @ w_gate
    g = (F.gelu(gate, approximate="tanh") if activation == "gelu"
         else F.silu(gate))
    return (g * (x @ w_up)) @ w_down


def layer_flags(cfg: ModelConfig) -> list:
    """Per-layer is_local flag for alt_local_global patterns (gemma2: even
    layers local). A host list: the port's layer loop is Python."""
    if cfg.layer_pattern == "alt_local_global":
        return [l % 2 == 0 for l in range(cfg.n_layers)]
    return [False] * cfg.n_layers
