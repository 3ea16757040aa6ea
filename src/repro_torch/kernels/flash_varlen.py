"""Ragged (varlen) flash attention over token-packed streams.

Replaces the two Pallas TPU kernels of ``repro/kernels/flash_varlen.py``:
``flash_varlen_call`` (self-attention over the packed Refresh stream) and
``flash_varlen_cross_call`` (packed Reuse block queries against the gathered
``[retain ; live block]`` KV stream). One CUDA kernel serves both
(``csrc/flash_varlen.cu``): self-attention is the cross case whose KV stream
is the query stream, with its positions and validity shared by every head.

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
HEAD_DIMS = (16, 32, 64, 112, 128)


def varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
                           is_local: bool, *, softcap: float = 0.0,
                           causal: bool = False, window: int = 0):
    """The kernel's function, step by step on whole tensors.

    q [K, Tq·G, dh]; k/v [K, Tkv, dh]; q_pos/q_seg [Tq]; kv_pos/kv_valid
    [K, Tkv]; kv_seg [Tkv] -> [K, Tq·G, dh] float32."""
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
    p = torch.softmax(z.masked_fill(~ok, -1e30), dim=-1)
    return p.to(v.dtype).float() @ v.float()


def _launch(counter, q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
            kv_head_stride: int, is_local: bool, softcap: float,
            causal: bool, window: int):
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
    o = torch.empty((K, RG, dh), dtype=torch.float32, device=q.device)
    lib = build.library()
    code = lib.repro_flash_varlen(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q_pos.data_ptr(), q_seg.data_ptr(), kv_pos.data_ptr(),
        kv_seg.data_ptr(), kv_valid.data_ptr(),
        K, RG, RG // Tq, Tq, Tkv, kv_head_stride, dh, build.dtype_code(q),
        float(dh ** -0.5), float(softcap), int(causal), int(window),
        int(bool(is_local)), torch.cuda.current_stream(q.device).cuda_stream)
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
