"""Per-KV-head importance scores (paper C3).

Replaces the two Pallas kernels of ``repro/kernels/select_pack.py``, both
with ``csrc/head_score.cu``:

* ``head_score_varlen_call``: over the packed Refresh stream,
  ``out[r, k, t] = max over request r's block query rows q (all G heads of
  the group) of Q[r, k, q] · K[k, t]`` where ``seg[t] == r``, and ``-inf``
  elsewhere;
* ``head_score_call``: over a padded batch, ``out[b, k, s] = max over the
  Sb·G rows q of Q[b, k, q] · K[b, k, s]``. No model code of the reference
  reaches it (its padded ``sparse_select.head_scores`` is plain jnp, and so
  is the port's); only its wrapper ``ops.head_score`` does.

A raw dot product, without the ``dh^-1/2`` scale. The local max-pool, top-k
and gather that follow stay plain PyTorch (``models/sparse_select.py``), as
they are plain XLA in the reference.

The kernel (one CTA per 64-key tile and KV head, tensor-core products in
bfloat16) reads the keys in place through their strides: ``k`` may be any
view whose last dimension is unit-stride, such as the ``[K, T, dh]``
permutation of the Refresh path's ``[T, K, dh]`` keys. It loads 16-byte
pieces, so every tensor it reads starts on a 16-byte boundary and steps by
whole 16-byte units; a view that does not raises ``ValueError`` (no copy is
made in its place). ``q`` and ``seg`` are contiguous.

Each wrapper runs its plain version only for CPU tensors; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SCORE = build.counter("head_score_varlen")
PADDED = build.counter("head_score")


def head_score_varlen_plain(q, k, seg):
    """q [R, K, Rq, dh]; k [K, T, dh]; seg [T] int32 -> [R, K, T] f32."""
    R = q.shape[0]
    z = torch.einsum("rkqd,ktd->rkqt", q.float(), k.float())
    best = z.amax(dim=2)
    own = seg[None, :] == torch.arange(R, dtype=seg.dtype,
                                       device=seg.device)[:, None]
    return best.masked_fill(~own[:, None, :], float("-inf"))


def check_layout(name: str, what: str, t: torch.Tensor) -> None:
    """The kernel's 16-byte loads: a unit-stride last dimension of whole
    16-byte units, a 16-byte aligned base and 16-byte steps along every
    other dimension of more than one element."""
    unit, steps = t.element_size(), t.stride()
    if steps[-1] != 1 or t.shape[-1] * unit % 16:
        raise ValueError(f"{name}: {what} rows must be unit-stride and whole "
                         f"16-byte units, got shape {tuple(t.shape)} strides "
                         f"{steps}")
    odd = t.data_ptr() % 16
    for n, s in zip(t.shape, steps[:-1]):
        odd = odd or (n > 1 and s * unit % 16)
    if odd:
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary "
                         f"and step by 16-byte units (the kernel loads 16 "
                         f"bytes at a time), got strides {steps}")


def _launch_checks(name, q, k, *rest):
    build.require_cuda(name, q, *rest)
    if k.device != q.device:
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {k.device} and {q.device}")
    if q.dtype != k.dtype:
        raise TypeError(f"{name}: q/k dtypes differ")
    check_layout(name, "q", q)
    check_layout(name, "k", k)


def head_score_varlen_call(q, k, seg):
    """Raw per-KV-head scores of every request against the flat stream.
    q [R, K, Rq, dh]; k [K, T, dh], any view of unit stride along dh; seg
    [T] int32, ascending (``PAD_SEG`` on bucket padding)."""
    if q.device.type == "cpu":
        SCORE.plain_calls += 1
        return head_score_varlen_plain(q, k, seg)
    name = SCORE.name
    R, K, Rq, dh = q.shape
    T = k.shape[1]
    if k.shape != (K, T, dh) or seg.shape != (T,) or 0 in (R, Rq, T) or \
            dh > 256:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} seg{tuple(seg.shape)}")
    _launch_checks(name, q, k, seg)
    if seg.dtype != torch.int32:
        raise TypeError(f"{name}: seg must be int32")
    out = torch.empty((R, K, T), dtype=torch.float32, device=q.device)
    code = build.library().repro_head_score_varlen(
        q.data_ptr(), k.data_ptr(), seg.data_ptr(), out.data_ptr(),
        R, K, Rq, T, dh, k.stride(0), k.stride(1), build.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, name)
    SCORE.launches += 1
    return out


def head_score_plain(q, k):
    """q [B, K, Rq, dh]; k [B, K, S, dh] -> [B, K, S] f32."""
    return torch.einsum("bkrd,bksd->bkrs", q.float(), k.float()).amax(dim=2)


def head_score_call(q, k):
    """Raw per-KV-head scores of a padded batch (replaces
    ``repro/kernels/select_pack.py::head_score_call``). q [B, K, Rq, dh];
    k [B, K, S, dh], any view of unit stride along dh."""
    if q.device.type == "cpu":
        PADDED.plain_calls += 1
        return head_score_plain(q, k)
    name = PADDED.name
    B, K, Rq, dh = q.shape
    S = k.shape[2]
    if k.shape != (B, K, S, dh) or 0 in (B, K, Rq, S) or dh > 256:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    _launch_checks(name, q, k)
    out = torch.empty((B, K, S), dtype=torch.float32, device=q.device)
    code = build.library().repro_head_score(
        q.data_ptr(), k.data_ptr(), out.data_ptr(), B, K, Rq, S, dh,
        k.stride(0), k.stride(1), k.stride(2), build.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, name)
    PADDED.launches += 1
    return out
