"""Ragged (varlen) flash attention over token-packed streams.

Replaces the two Pallas TPU kernels of ``repro/kernels/flash_varlen.py``:
``flash_varlen_call`` (self-attention over the packed Refresh stream) and
``flash_varlen_cross_call`` (packed Reuse block queries against the gathered
``[retain ; live block]`` KV stream). One CUDA kernel serves both
(``csrc/flash_varlen.cu``): self-attention is the cross case whose KV stream
is the query stream, with its positions and validity shared by every head.
bfloat16 runs on the Hopper tile (``csrc/attn_sm90.cuh``, TMA and wgmma):
one CTA per (128 query rows, KV head, split), and per 128 of V's columns
at head_dim 256, each row tile visiting only the keys of its rows'
segments; where row tiles × K CTAs leave the card under-filled,
:func:`kv_splits` cuts each tile's key window into shares whose partials a
merge kernel folds. float32 runs on ``csrc/attn_tile.cuh`` with one split.

Contract, as in the Pallas kernels: q ``[K, Tq·G, dh]`` in the token-major
GQA row layout (row = t·G + g), k/v ``[K, Tkv, dh]``, segment ids ascending
along both streams (``PAD_SEG`` on bucket padding). A query attends to a key
iff the key is valid, both carry the same segment id, and the optional
causal / sliding-window (``is_local`` layers) tests pass. Masked logits are
``-1e30``; the output is divided by ``max(Σp, 1e-30)`` and returned in
float32. Rows whose keys are all masked (padding rows) are junk in both
implementations and depend on tile geometry.

Each wrapper runs its plain PyTorch version only for CPU tensors; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Segment id for bucket-padding tokens: sorts after every real request id so
# the streams stay segment-ascending (the kernel's tile skip relies on it).
PAD_SEG = 1 << 30

SELF = build.counter("flash_varlen")
CROSS = build.counter("flash_varlen_cross")
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
BM, BK = 128, 64      # the bfloat16 tile: query rows a CTA, keys a KV tile
# V's columns a bfloat16 CTA computes: Smem::NPV in csrc/attn_sm90.cuh, so
# ceil(dh / PV_COLS) is its Smem::DSPLIT (2 CTAs a row tile at dh 256); the
# two must change together
PV_COLS = 128


def kv_splits(RG: int, K: int, Tkv: int, n_sms: int = build.H100_SMS, *,
              dh: int) -> int:
    """CTAs per row tile along the keys, from the shapes alone: enough for
    the ``ceil(RG / BM)·K·ceil(dh / PV_COLS)`` row-tile CTAs to give at
    least one CTA an SM (one CTA fits an SM), and never more than the
    stream's KV tiles."""
    ctas = -(-RG // BM) * K * -(-dh // PV_COLS)
    return max(1, min(-(-Tkv // BK), -(-n_sms // ctas)))


def _masked_logits(q, k, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
                   is_local: bool, softcap: float, causal: bool, window: int):
    """The scaled, softcapped logits [K, Tq·G, Tkv] in float32, -1e30 where
    the mask removes the pair."""
    K, RG, dh = q.shape
    G = RG // q_pos.shape[0]
    z = torch.einsum("krd,ktd->krt", q.float(), k.float()) * dh ** -0.5
    if softcap:
        z = softcap * torch.tanh(z / softcap)
    ok = kv_valid[:, None, :] & (q_seg[None, :, None] == kv_seg[None, None, :])
    if causal:
        ok = ok & (q_pos[None, :, None] >= kv_pos[:, None, :])
    if window and is_local:
        ok = ok & ((q_pos[None, :, None] - kv_pos[:, None, :]).abs() <= window)
    ok = ok.repeat_interleave(G, dim=1)                     # [K, Tq·G, Tkv]
    return z.masked_fill(~ok, -1e30)


def varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
                           is_local: bool, *, softcap: float = 0.0,
                           causal: bool = False, window: int = 0):
    """The kernel's function, step by step on whole tensors.

    q [K, Tq·G, dh]; k/v [K, Tkv, dh]; q_pos/q_seg [Tq]; kv_pos/kv_valid
    [K, Tkv]; kv_seg [Tkv] -> [K, Tq·G, dh] float32."""
    z = _masked_logits(q, k, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
                       is_local, softcap, causal, window)
    p = torch.softmax(z, dim=-1)
    return p.to(v.dtype).float() @ v.float()


def split_merge_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
                      is_local: bool, *, splits: int, softcap: float = 0.0,
                      causal: bool = False, window: int = 0):
    """The bfloat16 kernel's split-KV law on whole tensors, for its tests.

    Each tile of BM rows takes the keys from the first key of its first
    row's segment to the last of its last row's; the window's BK-key tiles
    are cut into ``splits`` even shares, each giving the unnormalised
    partial (o, m, Σp) of its keys (an empty share: 0, -inf, 0), and the
    partials fold by the (max, rescaled Σ) law. Equal to
    :func:`varlen_attention_plain` on every row with an unmasked key; a row
    whose every share is empty gives 0."""
    K, RG, dh = q.shape
    G = RG // q_pos.shape[0]
    z = _masked_logits(q, k, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
                       is_local, softcap, causal, window)
    dev = q.device
    out = torch.zeros((K, RG, dh), device=dev)
    for r0 in range(0, RG, BM):
        r1 = min(RG, r0 + BM)
        lo = int(torch.searchsorted(kv_seg, q_seg[r0 // G]))
        hi = int(torch.searchsorted(kv_seg, q_seg[(r1 - 1) // G], right=True))
        nt = -(-(hi - lo) // BK) if hi > lo else 0
        parts = []
        for sp in range(splits):
            a = lo + sp * nt // splits * BK
            b = min(hi, lo + (sp + 1) * nt // splits * BK)
            if b <= a:
                parts.append((torch.zeros((K, r1 - r0, dh), device=dev),
                              torch.full((K, r1 - r0), float("-inf"),
                                         device=dev),
                              torch.zeros((K, r1 - r0), device=dev)))
                continue
            zs = z[:, r0:r1, a:b]
            m = zs.amax(dim=-1)
            p = torch.exp(zs - m[..., None])
            parts.append((p.to(v.dtype).float() @ v[:, a:b].float(), m,
                          p.sum(dim=-1)))
        m = torch.stack([m for _, m, _ in parts]).amax(dim=0)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        den = torch.zeros_like(m)
        acc = torch.zeros((K, r1 - r0, dh), device=dev)
        for o_s, m_s, s_s in parts:
            w = torch.exp(m_s - m)
            den = den + s_s * w
            acc = acc + o_s * w[..., None]
        out[:, r0:r1] = acc / den.clamp_min(1e-30)[..., None]
    return out


def _launch(counter, q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
            kv_head_stride: int, is_local: bool, softcap: float,
            causal: bool, window: int, splits: int | None = None):
    """Launch the kernel; ``splits`` (bfloat16 only) overrides
    :func:`kv_splits`."""
    name = counter.name
    K, RG, dh = q.shape
    Tq, Tkv = q_seg.shape[0], k.shape[1]
    build.require_cuda(name, q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q/k/v dtypes differ")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if k.shape != (K, Tkv, dh) or v.shape != k.shape or RG % Tq or \
            RG == 0 or Tkv == 0:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} Tq={Tq}")
    for t in (q_pos, q_seg, kv_pos, kv_seg):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: positions/segments must be int32")
    if kv_valid.dtype != torch.bool:
        raise TypeError(f"{name}: kv_valid must be bool")
    if q.dtype == torch.bfloat16:
        build.require_tma(name, q, k, v)
        if splits is None:
            splits = kv_splits(RG, K, Tkv, build.sm_count(q.device), dh=dh)
    elif splits not in (None, 1):
        raise ValueError(f"{name}: only the bfloat16 kernel splits the keys")
    splits = splits or 1
    o = torch.empty((K, RG, dh), dtype=torch.float32, device=q.device)
    # the splits' partials (o, then (m, Σp)), alive until the launch
    ws = (torch.empty((splits * K * RG * (dh + 2),), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    code = build.library().repro_flash_varlen(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q_pos.data_ptr(), q_seg.data_ptr(), kv_pos.data_ptr(),
        kv_seg.data_ptr(), kv_valid.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        K, RG, RG // Tq, Tq, Tkv, kv_head_stride, dh, build.dtype_code(q),
        float(dh ** -0.5), float(softcap), int(causal), int(window),
        int(bool(is_local)), splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, name)
    counter.launches += 1
    return o


def flash_varlen_call(q, k, v, pos, seg, kv_valid, is_local: bool = False, *,
                      softcap: float = 0.0, causal: bool = False,
                      window: int = 0):
    """Self-attention over one packed stream (replaces
    ``repro/kernels/flash_varlen.py::flash_varlen_call``).

    q [K, T·G, dh]; k/v [K, T, dh]; pos/seg [T] int32; kv_valid [T] bool."""
    if q.device.type == "cpu":
        SELF.plain_calls += 1
        K, T = k.shape[0], k.shape[1]
        return varlen_attention_plain(
            q, k, v, pos, seg, pos.expand(K, T), seg, kv_valid.expand(K, T),
            is_local, softcap=softcap, causal=causal, window=window)
    return _launch(SELF, q, k, v, pos, seg, pos, seg, kv_valid, 0, is_local,
                   softcap, causal, window)


def flash_varlen_cross_call(q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
                            is_local: bool = False, *, softcap: float = 0.0,
                            causal: bool = False, window: int = 0):
    """Packed block queries against a distinct KV stream (replaces
    ``repro/kernels/flash_varlen.py::flash_varlen_cross_call``).

    q [K, Tq·G, dh]; k/v [K, Tkv, dh]; q_pos/q_seg [Tq]; kv_seg [Tkv];
    kv_pos/kv_valid [K, Tkv] (head-centric selection keeps a different
    token set per KV head)."""
    if q.device.type == "cpu":
        CROSS.plain_calls += 1
        return varlen_attention_plain(
            q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid, is_local,
            softcap=softcap, causal=causal, window=window)
    return _launch(CROSS, q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
                   k.shape[1], is_local, softcap, causal, window)
