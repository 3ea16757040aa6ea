"""Fused logit -> (argmax, max, Σexp) over the vocabulary (paper C1).

Replaces ``repro/kernels/logit_argmax.py::fused_logit_argmax_call``
(Pallas). The ``[T, V]`` logits never exist in device memory: each CTA of
``csrc/logit_argmax.cu`` (a persistent grid, one CTA an SM) projects a T
tile onto one split of the vocabulary, a run of whole 128-column tiles,
keeping an online (max, lowest argmax, Σexp(z − max)) per row in
registers, and a second small kernel merges the splits by the law of the reference's
vocab-sharded path (``repro/kernels/ops.py::_sharded_logit_argmax``):
``m = max mᵢ``, ``idx`` from the lowest split reaching ``m``,
``s = Σ sᵢ·exp(mᵢ − m)``. Ties keep the lowest vocabulary index. An optional
final softcap applies to every logit. T tiles without a valid row skip their
vocabulary loop and return (0, -inf, 0).

``w`` is ``[D, V]`` (``w_layout="dv"``) or the tied ``[V, D]`` table
(``"vd"``). Returns (idx int32, m f32, s f32), each ``[T]``; the caller forms
``conf = 1/s`` and masks invalid rows.

The wrapper runs the plain version only for CPU tensors; on a CUDA tensor it
launches the kernels or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

ARGMAX = build.counter("fused_logit_argmax")
V_TILE = 128          # the kernel's vocabulary tile; splits are multiples
PLAIN_V_CHUNK = 16384
H100_SMS = build.H100_SMS


def vocab_split(V: int, n_ctas: int = H100_SMS) -> int:
    """Columns per split: the vocabulary's 128-column tiles spread evenly
    over at most ``n_ctas`` CTAs (the card's SM count: one CTA an SM), whole
    tiles each. The ``ceil(V / split)`` splits cover ``[0, V)`` and none is
    empty."""
    tiles = -(-V // V_TILE)
    return -(-tiles // max(1, n_ctas)) * V_TILE


def fused_logit_argmax_plain(h, w, *, softcap: float = 0.0,
                             w_layout: str = "dv"):
    """The kernel's function, step by step: an online max / argmax / Σexp
    over vocabulary chunks, in float32. Every row is computed."""
    T = h.shape[0]
    V = w.shape[1] if w_layout == "dv" else w.shape[0]
    hf = h.float()
    m = torch.full((T,), float("-inf"), device=h.device)
    s = torch.zeros((T,), device=h.device)
    idx = torch.zeros((T,), dtype=torch.int32, device=h.device)
    for v0 in range(0, V, PLAIN_V_CHUNK):
        v1 = min(V, v0 + PLAIN_V_CHUNK)
        wc = w[:, v0:v1] if w_layout == "dv" else w[v0:v1].t()
        z = hf @ wc.float()
        if softcap:
            z = softcap * torch.tanh(z / softcap)
        lm, li = z.max(dim=1)       # first maximal index on ties
        m_new = torch.maximum(m, lm)
        s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(1)
        idx = torch.where(lm > m, li.to(torch.int32) + v0, idx)
        m = m_new
    return idx, m, s


def fused_logit_argmax_call(h, w, valid, *, softcap: float = 0.0,
                            w_layout: str = "dv"):
    """h [T, D]; w [D, V] | [V, D]; valid [T] bool -> (idx, m, s)."""
    if w_layout not in ("dv", "vd"):
        raise ValueError(f"w_layout must be 'dv' or 'vd', got {w_layout!r}")
    if h.device.type == "cpu":
        ARGMAX.plain_calls += 1
        return fused_logit_argmax_plain(h, w, softcap=softcap,
                                        w_layout=w_layout)
    name = ARGMAX.name
    build.require_cuda(name, h, w, valid)
    T, D = h.shape
    V = w.shape[1] if w_layout == "dv" else w.shape[0]
    if h.dtype != w.dtype:
        raise TypeError(f"{name}: h/w dtypes differ")
    if (w_layout == "dv" and w.shape[0] != D) or \
            (w_layout == "vd" and w.shape[1] != D) or valid.shape != (T,) \
            or T == 0:
        raise ValueError(f"{name}: bad shapes h{tuple(h.shape)} "
                         f"w{tuple(w.shape)} valid{tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: valid must be bool")
    dev = h.device
    v_split = vocab_split(V, build.sm_count(dev))
    n_splits = -(-V // v_split)
    part_m = torch.empty((n_splits, T), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_splits, T), dtype=torch.int32, device=dev)
    part_s = torch.empty((n_splits, T), dtype=torch.float32, device=dev)
    idx = torch.empty((T,), dtype=torch.int32, device=dev)
    m = torch.empty((T,), dtype=torch.float32, device=dev)
    s = torch.empty((T,), dtype=torch.float32, device=dev)
    code = build.library().repro_logit_argmax(
        h.data_ptr(), w.data_ptr(), valid.data_ptr(), part_m.data_ptr(),
        part_i.data_ptr(), part_s.data_ptr(), idx.data_ptr(), m.data_ptr(),
        s.data_ptr(), T, D, V, v_split, n_splits, int(w_layout == "vd"),
        build.dtype_code(h), float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, name)
    ARGMAX.launches += 1
    return idx, m, s
