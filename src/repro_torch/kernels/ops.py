"""Model-layer wrappers around the kernels (``repro/kernels/ops.py`` without
the mesh branches).

Each adapts the model's ``[T, H, dh]`` tensors to its kernel's head-major
layout (GQA rows token-major: row = t·G + g, query head h = k·G + g) and
back, in the caller's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_refresh as FR
from repro_torch.kernels import flash_varlen as FV
from repro_torch.kernels import logit_argmax as LA
from repro_torch.kernels import select_pack as SP
from repro_torch.kernels import ssm_scan as SS


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def fused_logit_argmax(h, w, *, softcap: float = 0.0, w_layout: str = "dv",
                       valid=None):
    """h [T, D]; w [D, V] ("dv") or [V, D] ("vd", tied table) ->
    (ids [T] int32, conf [T] f32). Paper C1, fused. Invalid rows of a
    token-bucketed stream decode to (0, 0.0)."""
    T = h.shape[0]
    vld = (torch.ones((T,), dtype=torch.bool, device=h.device)
           if valid is None else valid.contiguous())
    ids, _, s = LA.fused_logit_argmax_call(
        h.contiguous(), w, vld, softcap=softcap, w_layout=w_layout)
    conf = 1.0 / s.clamp_min(1e-30)
    if valid is not None:
        ids = torch.where(valid, ids, torch.zeros_like(ids))
        conf = torch.where(valid, conf, torch.zeros_like(conf))
    return ids, conf


def flash_varlen_attention(q, k, v, *, seg_ids, positions, kv_valid,
                           window: int = 0, is_local: bool = False,
                           softcap: float = 0.0, causal: bool = False):
    """Ragged attention over a token-packed stream. q [T, H, dh];
    k/v [T, K, dh]; seg_ids/positions [T]; kv_valid [T] -> [T, H, dh]."""
    T, H, dh = q.shape
    K = k.shape[1]
    G = H // K
    qr = q.reshape(T, K, G, dh).permute(1, 0, 2, 3).reshape(K, T * G, dh)
    out = FV.flash_varlen_call(
        qr.contiguous(), k.permute(1, 0, 2).contiguous(),
        v.permute(1, 0, 2).contiguous(), _i32(positions), _i32(seg_ids),
        kv_valid.contiguous(), is_local, softcap=softcap, causal=causal,
        window=window)
    out = out.reshape(K, T, G, dh).permute(1, 0, 2, 3).reshape(T, H, dh)
    return out.to(q.dtype)


def flash_varlen_cross_attention(q, k, v, *, q_seg, q_pos, kv_seg, kv_pos,
                                 kv_valid, window: int = 0,
                                 is_local: bool = False, softcap: float = 0.0,
                                 causal: bool = False):
    """Packed-Reuse cross attention. q [Tq, H, dh] packed block queries;
    k/v [K, Tkv, dh] head-major KV stream; q_seg/q_pos [Tq]; kv_seg [Tkv];
    kv_pos/kv_valid [K, Tkv] -> [Tq, H, dh]."""
    Tq, H, dh = q.shape
    K = k.shape[0]
    G = H // K
    qr = q.reshape(Tq, K, G, dh).permute(1, 0, 2, 3).reshape(K, Tq * G, dh)
    out = FV.flash_varlen_cross_call(
        qr.contiguous(), k.contiguous(), v.contiguous(), _i32(q_pos),
        _i32(kv_pos), _i32(q_seg), _i32(kv_seg), kv_valid.contiguous(),
        is_local, softcap=softcap, causal=causal, window=window)
    out = out.reshape(K, Tq, G, dh).permute(1, 0, 2, 3).reshape(Tq, H, dh)
    return out.to(q.dtype)


def packed_flash_attention_stats(qr, k_all, v_all, ok, *,
                                 softcap: float = 0.0):
    """Raw flash statistics for the exact split-attention merge of the
    padded Reuse. qr [B, K, R, dh] (rows sb·G + g); k_all/v_all
    [B, K, T, dh]; ok [B, K, Sm, T] bool (Sm = Sb, or 1) -> (o f32
    UNNORMALISED [B, K, R, dh], m [B, K, R], s [B, K, R])."""
    return FA.packed_flash_attention_call(
        qr.contiguous(), k_all.contiguous(), v_all.contiguous(),
        ok.contiguous(), softcap=softcap)


def packed_flash_attention(q, k_all, v_all, ok, *, softcap: float = 0.0):
    """Padded Reuse attention, the model-layer contract: q [B, Sb, H, dh];
    k_all/v_all [B, K, T, dh]; ok [B, K, Sm, T] bool -> [B, Sb, H, dh]."""
    B, Sb, H, dh = q.shape
    K = k_all.shape[1]
    G = H // K
    qr = q.reshape(B, Sb, K, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, K, Sb * G, dh)
    out, _, s = packed_flash_attention_stats(qr, k_all, v_all, ok,
                                             softcap=softcap)
    out = out / s.clamp_min(1e-30)[..., None]
    out = out.reshape(B, K, Sb, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, Sb, H, dh)
    return out.to(q.dtype)


def flash_refresh_attention(q, k, v, *, q_pos, kv_pos, kv_valid, mask_mode,
                            window, is_local, softcap):
    """Padded full-sequence attention (the Refresh prefill), the
    model-layer contract of ``layers.attention``: q [B, S, H, dh]; k/v
    [B, S, K, dh]; q_pos/kv_pos [B, S]; kv_valid [B, S] -> [B, S, H, dh]."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qr = q.reshape(B, S, K, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, K, S * G, dh)
    out = FR.flash_refresh_call(
        qr.contiguous(), k.permute(0, 2, 1, 3).contiguous(),
        v.permute(0, 2, 1, 3).contiguous(), _i32(q_pos), _i32(kv_pos),
        kv_valid.contiguous(), bool(is_local), softcap=softcap,
        causal=mask_mode == "causal", window=window)
    out = out.reshape(B, K, S, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, S, H, dh)
    return out.to(q.dtype)


def head_score(q_block, k_full):
    """q_block [B, Sb, H, dh]; k_full [B, S, K, dh] -> [B, K, S] f32 raw
    (pre-maxpool) importance scores of a padded batch. The kernel reads
    k_full in place, as its [B, K, S, dh] view."""
    B, Sb, H, dh = q_block.shape
    K = k_full.shape[2]
    G = H // K
    qr = (q_block.reshape(B, Sb, K, G, dh).permute(0, 2, 1, 3, 4)
          .reshape(B, K, Sb * G, dh))
    return SP.head_score_call(qr.contiguous(), k_full.permute(0, 2, 1, 3))


def head_score_varlen(q_block, k_flat, seg_ids):
    """q_block [R, Sb, H, dh]; k_flat [T, K, dh]; seg_ids [T] ->
    [R, K, T] f32 raw scores (-inf off-segment). The kernel reads k_flat in
    place, as its [K, T, dh] view."""
    R, Sb, H, dh = q_block.shape
    K = k_flat.shape[1]
    G = H // K
    qr = (q_block.reshape(R, Sb, K, G, dh).permute(0, 2, 1, 3, 4)
          .reshape(R, K, Sb * G, dh))
    return SP.head_score_varlen_call(qr.contiguous(), k_flat.permute(1, 0, 2),
                                     _i32(seg_ids))


def ssm_segment_scan(xh, dt, A, Bm, Cm, reset, cap_rows, *, chunk: int = 64):
    """Segment-reset SSD scan over a packed stream (the model contract of
    ``repro/kernels/ops.py::ssm_segment_scan``).

    xh [T, H, P]; dt [T, H] (post-softplus); A [H] (negative); Bm/Cm
    [T, N]; reset [T] bool (True on each request's first token); cap_rows
    [R] flat row AFTER which request r's state is captured (-1: zero).
    Returns (y [T, H, P] f32, captured [R, H, P, N] f32)."""
    T = xh.shape[0]
    ct = min(chunk, T)
    while T % ct:
        ct //= 2
    dtf = dt.float()
    xdt = (xh.float() * dtf[..., None]).contiguous()
    dA = (dtf * A.float()[None, :]).contiguous()
    y, cap, _ = SS.ssm_segment_scan_call(
        xdt, dA, Bm.float().contiguous(), Cm.float().contiguous(),
        reset.float().contiguous(), _i32(cap_rows), chunk=ct)
    return y, cap
