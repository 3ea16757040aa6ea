"""Padded Reuse attention over head-major packed KV with an explicit mask.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
packed_flash_attention_call`` with ``csrc/packed_flash_attention.cu``:
bfloat16 runs a warp per (request, KV head, 8 or 16 query rows) on
mma.sync with the rows on the narrow side and a cp.async K/V ring a warp;
float32 (the reduced checks) runs the first tile.

Contract, as in the Pallas kernel: q ``[B, K, R, dh]`` (R = Sb·G query rows
per KV head, row = sb·G + g), k/v ``[B, K, T, dh]`` (the request's packed
retained cache), mask ``[B, K, Sm, T]`` bool with query row r reading mask
row ``r // (R // Sm)`` (Sm = Sb, or 1 for a mask every row shares). Returns
the UNNORMALISED float32 ``o [B, K, R, dh]`` and the statistics ``m`` and
``s [B, K, R]``: masked logits are ``-1e30``, so a row whose keys are all
masked comes out with ``m = -1e30``, ``s = T`` and ``o = Σ v``, which the
exact split merge of the padded Reuse weighs by ``exp(-1e30 - m) = 0``.

The wrapper runs its plain PyTorch version only for CPU tensors; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_varlen import HEAD_DIMS

PACKED = build.counter("packed_flash_attention")


def packed_attention_plain(q, k, v, mask, *, softcap: float = 0.0):
    """The kernel's function on whole rows: (o, m, s) as above."""
    B, K, R, dh = q.shape
    Sm = mask.shape[2]
    z = torch.einsum("bkrd,bktd->bkrt", q.float(), k.float()) * dh ** -0.5
    if softcap:
        z = softcap * torch.tanh(z / softcap)
    ok = mask.repeat_interleave(R // Sm, dim=2)              # [B, K, R, T]
    z = z.masked_fill(~ok, -1e30)
    m = z.amax(dim=-1)
    p = torch.exp(z - m[..., None])
    o = p.to(v.dtype).float() @ v.float()
    return o, m, p.sum(dim=-1)


def packed_flash_attention_call(q, k, v, mask, *, softcap: float = 0.0):
    """Raw flash statistics of the padded Reuse (replaces
    ``repro/kernels/flash_attention.py::packed_flash_attention_call``)."""
    if q.device.type == "cpu":
        PACKED.plain_calls += 1
        return packed_attention_plain(q, k, v, mask, softcap=softcap)
    name = PACKED.name
    build.require_cuda(name, q, k, v, mask)
    B, K, R, dh = q.shape
    T, Sm = k.shape[2], mask.shape[2]
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q/k/v dtypes differ")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if k.shape != (B, K, T, dh) or v.shape != k.shape or \
            mask.shape != (B, K, Sm, T) or 0 in (B, K, R, T, Sm) or R % Sm:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"mask{tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError(f"{name}: the bfloat16 kernel copies q/k/v 16 "
                         f"bytes at a time and needs 16-byte aligned "
                         f"tensors")
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, K, R, dh), **f32)
    m = torch.empty((B, K, R), **f32)
    s = torch.empty((B, K, R), **f32)
    code = build.library().repro_packed_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        o.data_ptr(), m.data_ptr(), s.data_ptr(), B, K, R, T, Sm, dh,
        build.dtype_code(q), float(dh ** -0.5), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, name)
    PACKED.launches += 1
    return o, m, s
