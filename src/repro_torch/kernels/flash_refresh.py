"""Padded full-sequence flash attention: the Refresh phase's prefill.

Replaces the Pallas TPU kernel ``repro/kernels/flash_refresh.py::
flash_refresh_call`` with ``csrc/flash_refresh.cu`` (one device; the
reference's shard_map branches are multi-device work).

Contract, as in the Pallas kernel: q ``[B, K, Sq·G, dh]`` in the token-major
GQA row layout (row = t·G + g), k/v ``[B, K, S, dh]``, ``q_pos [B, Sq]``,
``kv_pos [B, S]`` int32, ``kv_valid [B, S]`` bool, ``is_local`` a runtime
flag. A query attends to a key iff the key is valid and the optional causal
and window (``|Δpos| <= window`` on local layers) tests pass, after the
optional softcap; masked logits are ``-1e30`` and the output is divided by
``max(Σp, 1e-30)``, in float32.

The wrapper runs its plain PyTorch version only for CPU tensors; on a CUDA
tensor it launches the kernel or raises. On meta tensors (the dry run) it
returns the kernel's output shape and computes nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_varlen import HEAD_DIMS

REFRESH = build.counter("flash_refresh")


def refresh_attention_plain(q, k, v, q_pos, kv_pos, kv_valid,
                            is_local: bool, *, softcap: float = 0.0,
                            causal: bool = False, window: int = 0):
    """The kernel's function on whole rows -> [B, K, Sq·G, dh] float32."""
    B, K, RG, dh = q.shape
    G = RG // q_pos.shape[1]
    z = torch.einsum("bkrd,bktd->bkrt", q.float(), k.float()) * dh ** -0.5
    if softcap:
        z = softcap * torch.tanh(z / softcap)
    ok = kv_valid[:, None, :]                                # [B, 1, S]
    if causal:
        ok = ok & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window and is_local:
        ok = ok & ((q_pos[:, :, None] - kv_pos[:, None, :]).abs() <= window)
    ok = ok.expand(B, q_pos.shape[1], k.shape[2]).repeat_interleave(G, dim=1)
    p = torch.softmax(z.masked_fill(~ok[:, None], -1e30), dim=-1)
    return p.to(v.dtype).float() @ v.float()


def flash_refresh_call(q, k, v, q_pos, kv_pos, kv_valid, is_local=False, *,
                       softcap: float = 0.0, causal: bool = False,
                       window: int = 0):
    """Padded prefill attention (replaces
    ``repro/kernels/flash_refresh.py::flash_refresh_call``)."""
    if q.device.type == "cpu":
        REFRESH.plain_calls += 1
        return refresh_attention_plain(q, k, v, q_pos, kv_pos, kv_valid,
                                       is_local, softcap=softcap,
                                       causal=causal, window=window)
    name = REFRESH.name
    B, K, RG, dh = q.shape
    S, Sq = k.shape[2], q_pos.shape[1]
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q/k/v dtypes differ")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if k.shape != (B, K, S, dh) or v.shape != k.shape or \
            q_pos.shape != (B, Sq) or kv_pos.shape != (B, S) or \
            kv_valid.shape != (B, S) or 0 in (B, K, S, Sq) or RG % Sq:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} q_pos{tuple(q_pos.shape)} "
                         f"kv_pos{tuple(kv_pos.shape)}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError(f"{name}: positions must be int32")
    if kv_valid.dtype != torch.bool:
        raise TypeError(f"{name}: kv_valid must be bool")
    if q.device.type == "meta":
        # the dry run's shape pass (launch.dryrun --flash-refresh): the
        # kernel's output for what the kernel accepts, computing nothing
        # and launching nothing
        REFRESH.meta_calls += 1
        return torch.empty(q.shape, dtype=torch.float32, device="meta")
    build.require_cuda(name, q, k, v, q_pos, kv_pos, kv_valid)
    o = torch.empty((B, K, RG, dh), dtype=torch.float32, device=q.device)
    code = build.library().repro_flash_refresh(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(), kv_valid.data_ptr(),
        B, K, RG, Sq, S, dh, build.dtype_code(q), float(dh ** -0.5),
        float(softcap), int(causal), int(window), int(bool(is_local)),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, name)
    REFRESH.launches += 1
    return o
