"""Mamba2 (SSD) layers: the serving paths of ``repro.models.ssm``.

* :func:`mamba_block` — the padded **Refresh** (the oracle, and the
  baselines' path): one Mamba2 block over a ``[B, S]`` batch through the
  chunked :func:`ssd_scan`, optionally capturing each row's recurrent state
  and conv history at its active block. Plain PyTorch in float32, as the
  reference computes it in jnp outside any Pallas kernel.
* :func:`mamba_block_packed` — the packed **Refresh**: one Mamba2 block
  over a ragged ``[T]`` stream carrying every Refresh request of an
  iteration. The causal conv and the SSD recurrence both reset at segment
  boundaries (the conv by a segment mask, the scan in the
  ``ssm_segment_scan`` kernel, or in :func:`varlen_ssd_scan` beside it on
  the CPU), and each request's serving cache is captured in-stream.
* :func:`mamba_decode_block` — **Reuse**: the active block's ``Sb`` tokens
  run recurrently from the cached state (float32), without advancing the
  cache. Plain PyTorch, as it is plain jnp in the reference.

On a serving mesh whose model axis divides the state heads, ``w_z`` and
``out_proj`` hold this rank's ``d_inner/m`` (``launch.sharding.Rules``);
``w_xbc`` and ``w_dt`` stay whole, so each rank computes the whole conv
stream and ``dt`` and takes its state heads of ``x``, ``dt`` and ``A`` for
the scan (B and C are read whole: one group). The gate norm's mean square
sums over the model axis before the scale, and ``out_proj``'s partial
output sums over it too.
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


def local_heads(p, cfg: ModelConfig) -> int:
    """The state heads a (stacked or one-layer) Mamba2 weight set scans:
    ``Hs``, or ``Hs/m`` on a rank whose model axis divides them."""
    return p["w_z"].shape[-1] // cfg.ssm_head_dim


def _shard(p, cfg: ModelConfig):
    """(first state head, heads) of this rank's shard, or None when the
    inner width is whole."""
    hl = local_heads(p, cfg)
    return None if hl == cfg.ssm_heads else (L.tp_index() * hl, hl)


def _heads(p, cfg: ModelConfig, xin, dt, A):
    """The state heads this rank scans: ``xin [..., d_inner]`` as
    ``[..., H, P]``, ``dt [..., H]`` and ``A [H]``, cut to the rank's shard
    when the inner width is split."""
    xh = xin.reshape(xin.shape[:-1] + (cfg.ssm_heads, cfg.ssm_head_dim))
    sh = _shard(p, cfg)
    if sh is None:
        return xh, dt, A
    h0, hl = sh
    return xh[..., h0:h0 + hl, :], dt[..., h0:h0 + hl], A[h0:h0 + hl]


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
    sh = _shard(p, cfg)
    d_skip, g_scale = p["D_skip"], p["gate_norm"]
    if sh is not None:
        h0, hl = sh
        P = cfg.ssm_head_dim
        d_skip, g_scale = d_skip[h0:h0 + hl], g_scale[h0 * P:(h0 + hl) * P]
    y = y + d_skip.to(y.dtype)[:, None] * xh
    y = y.flatten(-2)
    g = y * F.silu(z.float()).to(y.dtype)
    if sh is None:
        return x + L.rms_norm(g, g_scale, cfg.rms_eps) @ p["out_proj"]
    # an RMSNorm over the whole d_inner: the mean square sums over ranks
    g32 = g.float()
    var = L.tp_sum(g32.square().sum(dim=-1, keepdim=True)) / cfg.d_inner
    g = (g32 * torch.rsqrt(var + cfg.rms_eps)
         * (1.0 + g_scale.float())).to(g.dtype)
    return x + L.tp_sum(g @ p["out_proj"])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> [..., T, T]; out[i, j] = sum of x[m] over j < m <= i,
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    lower = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~lower, float("-inf"))


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, init_state=None,
             return_chunk_states: bool = False):
    """Chunked SSD over a padded batch, in float32. x [B, S, H, P]; dt
    [B, S, H] (post-softplus); A [H] (negative); Bm/Cm [B, S, N];
    init_state [B, H, P, N] or None. Returns (y [B, S, H, P] in x's dtype,
    final state [B, H, P, N] float32), or with ``return_chunk_states`` (y,
    the state *entering* each chunk [B, S // chunk, H, P, N])."""
    Bb, S, H, Pd = x.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    xc = x.reshape(Bb, nc, chunk, H, Pd)
    dtc = dt.reshape(Bb, nc, chunk, H).float()
    Bc = Bm.reshape(Bb, nc, chunk, N).float()
    Cc = Cm.reshape(Bb, nc, chunk, N).float()
    dA = (dtc * A.float()).permute(0, 3, 1, 2)          # [B, H, nc, l]
    dA_cs = torch.cumsum(dA, dim=-1)
    xdt = xc.float() * dtc[..., None]                   # [B, nc, l, H, P]

    # 1) intra-chunk (diagonal blocks)
    Ldec = torch.exp(_segsum(dA))                       # [B, H, nc, l, l]
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, Ldec, xdt)

    # 2) per-chunk end states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)   # [B, H, nc, l]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xdt)

    # 3) inter-chunk recurrence, the initial state as chunk -1; the decay
    # of an empty span is exp(-inf) = 0, kept finite by the guard
    if init_state is None:
        init_state = torch.zeros((Bb, H, Pd, N), dtype=torch.float32,
                                 device=x.device)
    padded = F.pad(dA_cs[..., -1], (1, 0))              # [B, H, nc + 1]
    dec = torch.exp(_segsum(padded))
    dec = torch.where(torch.isfinite(dec), dec, 0.0)
    all_states = torch.cat([init_state.float()[:, None], states], dim=1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dec, all_states)
    states_in = new_states[:, :-1]                      # [B, nc, H, P, N]

    # 4) state -> output within each chunk
    out_decay = torch.exp(dA_cs)                        # [B, H, nc, l]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states_in, out_decay)
    y = (y_diag + y_off).reshape(Bb, S, H, Pd).to(x.dtype)
    if return_chunk_states:
        return y, states_in
    return y, new_states[:, -1]


def varlen_ssd_scan(xh, dt, A, Bm, Cm, reset, cap_rows):
    """Segment-reset SSD scan over a packed ``[T]`` stream: the plain
    fallback beside the ``ssm_segment_scan`` kernel (CPU only), as the
    reference's ``varlen_ssd_scan`` is beside its Pallas kernel.

    The recurrence ``h_t = a_t·h_{t-1} + b_t`` (``a_t = exp(dt_t·A)``,
    ``b_t = dt_t·B_t⊗x_t``) runs as one token-level inclusive scan with
    ``a_t`` zeroed at segment starts, so requests packed back to back cannot
    leak state into each other. The scan is log-depth (Hillis-Steele): at
    step d every row t ≥ d combines with row t - d, ``(a, b)_t <- (a_{t-d}
    a_t, b_{t-d} a_t + b_t)``, the reference's ``associative_scan``
    combine. xh [T, H, P]; dt [T, H]; A [H]; Bm/Cm [T, N]; reset [T] bool;
    cap_rows [R] (state captured after that row; -1 gives 0). Returns (y
    [T, H, P] in xh's dtype, captured states [R, H, P, N] float32); it holds
    every token's state, [T, H, P, N] float32."""
    dtf = dt.float()
    a = torch.exp(dtf * A.float()).masked_fill(reset[:, None], 0.0)
    b = torch.einsum("th,tn,thp->thpn", dtf, Bm.float(), xh.float())
    T, d = xh.shape[0], 1
    while d < T:
        b = torch.cat([b[:d], b[:-d] * a[d:, :, None, None] + b[d:]])
        a = torch.cat([a[:d], a[:-d] * a[d:]])
        d *= 2
    y = torch.einsum("tn,thpn->thp", Cm.float(), b)
    st = b[cap_rows.long().clamp(0, T - 1)]
    st = st.masked_fill(~(cap_rows >= 0)[:, None, None, None], 0.0)
    return y.to(xh.dtype), st


def _causal_conv(xbc, w, b, history):
    """Depthwise causal conv over [B, S, ch] after a [B, k-1, ch] history;
    w [k, ch]."""
    k, S = w.shape[0], xbc.shape[1]
    xin = torch.cat([history.to(xbc.dtype), xbc], dim=1)
    out = sum(xin[:, i:i + S] * w[i] for i in range(k))
    return F.silu(out + b)


def mamba_block(p, x, cfg: ModelConfig, conv_hist=None, init_state=None,
                return_state: bool = False, capture_at=None):
    """One Mamba2 block (residual included) over a padded batch, x
    [B, S, D]. With ``capture_at`` ([B] positions) also returns each row's
    serving cache at that position: the recurrent state entering the chunk
    that holds it (the chunk floor) and the ``ck-1`` pre-conv rows before
    it, zero in front of the sequence. With ``return_state`` also returns
    the final state and the conv history after the last row."""
    h = L.rms_norm(x, p["norm"], cfg.rms_eps)
    z, xbc_pre, dt = _project(p, h, cfg)
    Bb, S = x.shape[:2]
    ck, ch = cfg.ssm_conv_kernel, xbc_pre.shape[2]
    if conv_hist is None:
        conv_hist = xbc_pre.new_zeros((Bb, ck - 1, ch))
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"], conv_hist)
    xin, Bm, Cm = _split_xbc(xbc, cfg)
    xh, dt, A = _heads(p, cfg, xin, dt, -torch.exp(p["A_log"].float()))
    chunk = min(cfg.ssm_chunk, S)
    y, state_out = ssd_scan(xh, dt, A, Bm, Cm, chunk, init_state,
                            return_chunk_states=capture_at is not None)
    out = _gated_out(p, x, y, z, xh, cfg)
    if capture_at is not None:
        cap = capture_at.long()
        c0 = torch.div(cap, chunk, rounding_mode="floor").clamp(
            0, state_out.shape[1] - 1)
        state_at = state_out[torch.arange(Bb, device=x.device), c0]
        # ck-1 rows from position capture_at of the zero-front-padded
        # pre-conv stream: the history entering the active block
        padded = F.pad(xbc_pre, (0, 0, ck - 1, 0))
        rows = cap.clamp(0, S)[:, None] + torch.arange(ck - 1,
                                                       device=x.device)
        hist_at = torch.gather(padded, 1, rows[..., None].expand(-1, -1, ch))
        return out, state_at, hist_at
    if return_state:
        hist = torch.cat([conv_hist.to(xbc_pre.dtype), xbc_pre], dim=1)
        return out, state_out, hist[:, -(ck - 1):]
    return out


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
                       cu_seqlens, block_start, use_kernel: bool = False):
    """One Mamba2 block over a token-packed ``[1, T, D]`` stream.

    seg_ids/positions [T] (positions restart at 0 per request); cu_seqlens/
    block_start [R]. The captured state is the padded oracle's: the state
    *entering* the ``ssm_chunk`` that holds ``block_start``. The scan runs
    in the ``ssm_segment_scan`` kernel under ``use_kernel``, else in
    :func:`varlen_ssd_scan`. Returns (out [1, T, D], state_at [R, H, P, N]
    f32, hist_at [R, ck-1, ch])."""
    h = L.rms_norm(x, p["norm"], cfg.rms_eps)
    z, xbc_pre, dt = _project(p, h, cfg)
    xbc = _causal_conv_packed(xbc_pre, p["conv_w"], p["conv_b"], seg_ids)
    xin, Bm, Cm = _split_xbc(xbc, cfg)
    T = x.shape[1]
    xh, dt, A = _heads(p, cfg, xin[0], dt[0],
                       -torch.exp(p["A_log"].float()))
    chunk = cfg.ssm_chunk
    cap_pos = torch.div(block_start, chunk, rounding_mode="floor") * chunk
    cap_rows = torch.where(cap_pos > 0, cu_seqlens + cap_pos - 1,
                           torch.full_like(cap_pos, -1))
    scan = ops.ssm_segment_scan if use_kernel else varlen_ssd_scan
    y, state_at = scan(xh, dt, A, Bm[0], Cm[0], positions == 0, cap_rows)
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
    Sb = xb.shape[1]
    xh, dt, A = _heads(p, cfg, xin, dt, -torch.exp(p["A_log"].float()))
    xs, Bs, Cs = xh.float(), Bm.float(), Cm.float()
    st = state.float()
    ys = []
    for t in range(Sb):
        dA = torch.exp(dt[:, t] * A)                          # [B, H]
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], Bs[:, t], xs[:, t])
        st = st * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cs[:, t], st))
    return _gated_out(p, xb, torch.stack(ys, dim=1), z, xh, cfg)
