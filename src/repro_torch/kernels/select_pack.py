"""Per-KV-head importance scores over the packed Refresh stream (paper C3).

Replaces ``repro/kernels/select_pack.py::head_score_varlen_call`` (Pallas):
``out[r, k, t] = max over request r's block query rows q (all G heads of the
group) of Q[r, k, q] · K[k, t]`` where ``seg[t] == r``, and ``-inf``
elsewhere. A raw dot product, without the ``dh^-1/2`` scale. The local
max-pool, top-k and gather that follow stay plain PyTorch
(``models/sparse_select.py``), as they are plain XLA in the reference.

The wrapper runs the plain version only for CPU tensors; on a CUDA tensor it
launches ``csrc/head_score.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SCORE = build.counter("head_score_varlen")


def head_score_varlen_plain(q, k, seg):
    """q [R, K, Rq, dh]; k [K, T, dh]; seg [T] int32 -> [R, K, T] f32."""
    R = q.shape[0]
    z = torch.einsum("rkqd,ktd->rkqt", q.float(), k.float())
    best = z.amax(dim=2)
    own = seg[None, :] == torch.arange(R, dtype=seg.dtype,
                                       device=seg.device)[:, None]
    return best.masked_fill(~own[:, None, :], float("-inf"))


def head_score_varlen_call(q, k, seg):
    """Raw per-KV-head scores of every request against the flat stream."""
    if q.device.type == "cpu":
        SCORE.plain_calls += 1
        return head_score_varlen_plain(q, k, seg)
    name = SCORE.name
    build.require_cuda(name, q, k, seg)
    R, K, Rq, dh = q.shape
    T = k.shape[1]
    if q.dtype != k.dtype:
        raise TypeError(f"{name}: q/k dtypes differ")
    if k.shape != (K, T, dh) or seg.shape != (T,) or 0 in (R, Rq, T) or \
            dh > 256:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} seg{tuple(seg.shape)}")
    if seg.dtype != torch.int32:
        raise TypeError(f"{name}: seg must be int32")
    out = torch.empty((R, K, T), dtype=torch.float32, device=q.device)
    code = build.library().repro_head_score_varlen(
        q.data_ptr(), k.data_ptr(), seg.data_ptr(), out.data_ptr(),
        R, K, Rq, T, dh, build.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, name)
    SCORE.launches += 1
    return out
