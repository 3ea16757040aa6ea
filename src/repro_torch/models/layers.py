"""Shared layer primitives: RMSNorm, RoPE, the padded attention, gated
MLPs, per-layer flags.

Conventions as in ``repro.models.layers``: activations ``[..., D]``,
attention heads ``[..., H, dh]``, normalisation and RoPE in float32 and cast
back to the working dtype.

:func:`attention` is the padded, query-chunked exact attention of the
reference. On the card it runs as plain PyTorch (einsum, softmax) except
where ``use_kernel`` selects the ``flash_refresh`` kernel, because the
reference computes it in jnp outside any Pallas kernel on the engine's
path; only its ``use_kernel`` branch is a kernel there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

DEFAULT_Q_CHUNK = 1024


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, kv_pos: torch.Tensor,
              kv_valid: Optional[torch.Tensor] = None,
              q_seg: Optional[torch.Tensor] = None,
              kv_seg: Optional[torch.Tensor] = None,
              mask_mode: str = "bidirectional", window: int = 0,
              is_local: bool = False, attn_softcap: float = 0.0,
              q_chunk: int = DEFAULT_Q_CHUNK,
              use_kernel: bool = False) -> torch.Tensor:
    """Query-chunked exact attention. q [B, Sq, H, dh]; k/v [B, Sk, K, dh];
    q_pos [B, Sq]; kv_pos [B, Sk]; kv_valid [B, Sk] bool; q_seg/kv_seg
    [B, Sq]/[B, Sk] restrict attention to same-segment tokens. Returns
    [B, Sq, H, dh]. Masks are built per query chunk ([B, c, Sk]), never as
    a full [B, Sq, Sk] bias; masked logits are -1e30. ``use_kernel`` runs
    the ``flash_refresh`` kernel, under the reference's condition (self
    attention without segments)."""
    if use_kernel and q.shape[1] == k.shape[1] and q_seg is None:
        B, Sq = q.shape[:2]
        if kv_valid is None:
            kv_valid = torch.ones((B, Sq), dtype=torch.bool, device=q.device)
        return ops.flash_refresh_attention(
            q, k, v, q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
            mask_mode=mask_mode, window=window, is_local=is_local,
            softcap=attn_softcap)
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = dh ** -0.5
    qg = q.reshape(B, Sq, K, G, dh)
    has_seg = q_seg is not None
    needs_mask = (mask_mode == "causal") or window or \
        (kv_valid is not None) or has_seg

    def chunk_mask(qp, qs):        # qp/qs [B, c] -> [B, c, Sk] bool | None
        if not needs_mask:
            return None
        ok = torch.ones((B, qp.shape[1], kv_pos.shape[1]), dtype=torch.bool,
                        device=q.device)
        if kv_valid is not None:
            ok = ok & kv_valid[:, None, :]
        if has_seg:
            ok = ok & (qs[:, :, None] == kv_seg[:, None, :])
        if mask_mode == "causal":
            ok = ok & (qp[:, :, None] >= kv_pos[:, None, :])
        if window and is_local:
            ok = ok & ((qp[:, :, None] - kv_pos[:, None, :]).abs() <= window)
        return ok

    outs = []
    for c0 in range(0, Sq, q_chunk):
        qb = qg[:, c0: c0 + q_chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, k).float() * scale
        if attn_softcap:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        ok = chunk_mask(q_pos[:, c0: c0 + q_chunk],
                        q_seg[:, c0: c0 + q_chunk] if has_seg else None)
        if ok is not None:
            s = s.masked_fill(~ok[:, None, None], -1e30)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, v))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, dh)


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
