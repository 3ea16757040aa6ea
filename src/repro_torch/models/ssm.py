"""Mamba2 (SSD) layers, the packed serving halves of ``repro.models.ssm``.

* :func:`mamba_block_packed` — **Refresh**: one Mamba2 block over a ragged
  ``[T]`` stream carrying every Refresh request of an iteration. The causal
  conv and the SSD recurrence both reset at segment boundaries (the conv by
  a segment mask, the scan in the ``ssm_segment_scan`` kernel), and each
  request's serving cache (recurrent state + conv history at its active
  block) is captured in-stream.
* :func:`mamba_decode_block` — **Reuse**: the active block's ``Sb`` tokens
  run recurrently from the cached state (float32), without advancing the
  cache. Plain PyTorch, as it is plain jnp in the reference.

The padded ``ssd_scan`` / ``mamba_block`` and the associative-scan
``varlen_ssd_scan`` fallback are not ported yet (ROADMAP Queue A,
'the padded oracle path').
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


class SSMCache(NamedTuple):
    state: torch.Tensor     # [Lm, B, H, P, N] float32
    conv: torch.Tensor      # [Lm, B, ck-1, conv_ch]


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _project(p, h, cfg: ModelConfig):
    z = h @ p["w_z"]
    xbc = h @ p["w_xbc"]
    dt = F.softplus((h @ p["w_dt"]).float() + p["dt_bias"].float())
    return z, xbc, dt


def _split_xbc(xbc, cfg: ModelConfig):
    Din, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return xbc[..., :Din], xbc[..., Din:Din + GN], xbc[..., Din + GN:]


def _gated_out(p, x, y, z, xh, cfg: ModelConfig):
    """D skip, SiLU gate, gate norm and the output projection (residual
    included). y [..., H, P] float32 scan output; xh its input."""
    y = y.to(x.dtype)
    y = y + p["D_skip"].to(y.dtype)[:, None] * xh
    y = y.flatten(-2)
    y = L.rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"],
                   cfg.rms_eps)
    return x + y @ p["out_proj"]


def _causal_conv(xbc, w, b, history):
    """Depthwise causal conv over [B, S, ch] after a [B, k-1, ch] history;
    w [k, ch]."""
    k, S = w.shape[0], xbc.shape[1]
    xin = torch.cat([history.to(xbc.dtype), xbc], dim=1)
    out = sum(xin[:, i:i + S] * w[i] for i in range(k))
    return F.silu(out + b)


def _causal_conv_packed(xbc, w, b, seg):
    """Segment-masked depthwise causal conv over a packed stream. xbc
    [1, T, ch]; w [k, ch]; seg [T] request ids. Taps that would reach
    across a segment boundary contribute zero, so every request starts from
    an empty conv history."""
    k, T = w.shape[0], xbc.shape[1]
    out = xbc * w[k - 1]
    for i in range(k - 1):
        off = k - 1 - i
        shifted = F.pad(xbc, (0, 0, off, 0))[:, :T]
        sseg = F.pad(seg, (off, 0), value=-1)[:T]
        ok = (sseg == seg)[None, :, None]
        out = out + shifted.masked_fill(~ok, 0) * w[i]
    return F.silu(out + b)


def mamba_block_packed(p, x, cfg: ModelConfig, seg_ids, positions,
                       cu_seqlens, block_start):
    """One Mamba2 block over a token-packed ``[1, T, D]`` stream.

    seg_ids/positions [T] (positions restart at 0 per request); cu_seqlens/
    block_start [R]. The captured state is the padded oracle's: the state
    *entering* the ``ssm_chunk`` that holds ``block_start``. Returns
    (out [1, T, D], state_at [R, H, P, N] f32, hist_at [R, ck-1, ch])."""
    h = L.rms_norm(x, p["norm"], cfg.rms_eps)
    z, xbc_pre, dt = _project(p, h, cfg)
    xbc = _causal_conv_packed(xbc_pre, p["conv_w"], p["conv_b"], seg_ids)
    xin, Bm, Cm = _split_xbc(xbc, cfg)
    T = x.shape[1]
    xh = xin[0].reshape(T, cfg.ssm_heads, cfg.ssm_head_dim)
    A = -torch.exp(p["A_log"].float())
    chunk = cfg.ssm_chunk
    cap_pos = torch.div(block_start, chunk, rounding_mode="floor") * chunk
    cap_rows = torch.where(cap_pos > 0, cu_seqlens + cap_pos - 1,
                           torch.full_like(cap_pos, -1))
    y, state_at = ops.ssm_segment_scan(xh, dt[0], A, Bm[0], Cm[0],
                                       positions == 0, cap_rows)
    out = _gated_out(p, x, y[None], z, xh[None], cfg)
    # conv history entering the block: the ck-1 pre-conv rows before
    # block_start, zero where they precede the segment start
    ck = cfg.ssm_conv_kernel
    back = torch.arange(-(ck - 1), 0, dtype=block_start.dtype,
                        device=x.device)
    idx = block_start[:, None] + back[None]                  # within-request
    rows = (cu_seqlens[:, None] + idx).clamp(0, T - 1)
    hist_at = xbc_pre[0][rows.long()].masked_fill(~(idx >= 0)[..., None], 0)
    return out, state_at, hist_at


def mamba_decode_block(p, xb, cfg: ModelConfig, state, conv_hist):
    """Reuse phase: the active block from a cached state, recurrently.

    xb [B, Sb, D]; state [B, H, P, N]; conv_hist [B, ck-1, ch]. The cache
    is not advanced (diffusion re-denoises the same block)."""
    h = L.rms_norm(xb, p["norm"], cfg.rms_eps)
    z, xbc, dt = _project(p, h, cfg)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_hist)
    xin, Bm, Cm = _split_xbc(xbc, cfg)
    Bb, Sb = xb.shape[:2]
    xh = xin.reshape(Bb, Sb, cfg.ssm_heads, cfg.ssm_head_dim)
    A = -torch.exp(p["A_log"].float())
    xs, Bs, Cs = xh.float(), Bm.float(), Cm.float()
    st = state.float()
    ys = []
    for t in range(Sb):
        dA = torch.exp(dt[:, t] * A)                          # [B, H]
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], Bs[:, t], xs[:, t])
        st = st * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cs[:, t], st))
    return _gated_out(p, xb, torch.stack(ys, dim=1), z, xh, cfg)
