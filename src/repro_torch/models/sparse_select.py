"""Head-centric vs uniform sparse KV selection (paper §2.4 eq.5, §4.5
eq.6, contribution C3), as in ``repro.models.sparse_select``.

Two paths emit the same dense head-major ``PackedKV`` the slot pool stores:

* the padded path (:func:`select_and_pack`) scores a ``[B, S]`` batch in
  plain PyTorch, as the reference does in jnp (its ``head_score`` Pallas
  kernel is reached only through ``kernels.ops.head_score``), and gathers
  the winners with one ``torch.gather``;
* the varlen path (:func:`select_and_pack_varlen`) scores the flat packed
  stream in place (the ``head_score_varlen`` kernel); only the per-request
  score windows are gathered for the top-k, and the pack gathers exactly
  the ``retain`` winners from the flat K/V.

Sentinels, as in the reference: off-segment raw scores and the max-pool's
edge padding are ``-inf``; excluded positions (the active block, and rows
past the request's length) are ``-1e30``. Among equal scores the lower
position wins, which is ``jax.lax.top_k``'s order (``torch.topk`` promises
none), so a request with fewer candidates than ``retain`` packs the same
positions in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


class PackedKV(NamedTuple):
    k: torch.Tensor        # [B, K, R, dh]  post-RoPE keys, densely packed
    v: torch.Tensor        # [B, K, R, dh]
    pos: torch.Tensor      # [B, K, R] int32  original token positions
    valid: torch.Tensor    # [B, K, R] bool


def _local_maxpool(raw: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Local max-pooling with window w along the last axis; edges pad with
    -inf so invalid or foreign neighbours never leak in."""
    w = kernel_size
    if w > 1:
        inf = float("-inf")
        pads = [raw]
        for off in range(1, w // 2 + 1):
            pads.append(F.pad(raw[..., off:], (0, off), value=inf))
            pads.append(F.pad(raw[..., :-off], (off, 0), value=inf))
        raw = torch.stack(pads).amax(dim=0)
    return raw


def head_scores(q_block, k_full, kernel_size: int, s_chunk: int = 4096,
                valid=None):
    """Per-KV-head importance scores, eq.(6): ``maxpool_w(max over the G·Sb
    block query rows of Q_b · K_j)``. q_block [B, Sb, H, dh]; k_full
    [B, S, K, dh]; valid [B, S] bool -> [B, K, S] f32. The key axis runs in
    ``s_chunk`` tiles so the [B, K, G, Sb, S] tensor never exists whole;
    invalid rows are ``-inf`` BEFORE the max-pool, so a request's retained
    set cannot depend on what it is batched with."""
    B, Sb, H, dh = q_block.shape
    K = k_full.shape[2]
    qg = q_block.reshape(B, Sb, K, H // K, dh)
    raw = torch.cat([
        torch.einsum("bqkgd,bskd->bkgqs", qg, k_full[:, c0: c0 + s_chunk])
        .float().amax(dim=(2, 3))
        for c0 in range(0, k_full.shape[1], s_chunk)], dim=-1)
    if valid is not None:
        raw = raw.masked_fill(~valid[:, None, :], float("-inf"))
    return _local_maxpool(raw, kernel_size)


def head_scores_varlen(q_block, k_flat, seg_ids, kernel_size: int,
                       use_kernel: bool = True):
    """[R, K, T] f32: request r's eq.(6) scores at its own stream positions,
    -inf elsewhere, masked BEFORE the max-pool so a request's retained set
    cannot depend on what it is packed with. ``use_kernel=False`` is the
    reference's jnp fallback, plain PyTorch here (CPU only)."""
    if use_kernel:
        raw = ops.head_score_varlen(q_block, k_flat, seg_ids)
    else:
        R, Sb, H, dh = q_block.shape
        K = k_flat.shape[1]
        qg = q_block.reshape(R, Sb, K, H // K, dh)
        raw = torch.einsum("rqkgd,skd->rkgqs", qg, k_flat).float().amax(
            dim=(2, 3))
        own = seg_ids[None, :] == torch.arange(R, device=seg_ids.device)[
            :, None]
        raw = raw.masked_fill(~own[:, None, :], float("-inf"))
    return _local_maxpool(raw, kernel_size)


def select_indices(scores, retain: int, *, mode: str, exclude):
    """Top-``retain`` token indices per KV head, [B, K, retain] int32 in
    ascending position order. scores [B, K, S]; exclude [B, S] bool."""
    scores = scores.masked_fill(exclude[:, None, :], -1e30)
    if mode == "uniform":
        # Sparse-dLLM eq.(5): aggregate across heads -> one shared index set
        scores = scores.sum(dim=1, keepdim=True).expand_as(scores)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :retain], dim=-1).values.to(torch.int32)


def pack(idx, k_full, v_full, token_valid) -> PackedKV:
    """Gather the retained tokens into the dense head-major layout. idx
    [B, K, R]; k_full/v_full [B, S, K, dh]; token_valid [B, S]."""
    B, K, R = idx.shape
    dh = k_full.shape[-1]
    il = idx.long()
    ik = il[..., None].expand(B, K, R, dh)
    pk = torch.gather(k_full.permute(0, 2, 1, 3), 2, ik)
    pv = torch.gather(v_full.permute(0, 2, 1, 3), 2, ik)
    val = torch.gather(token_valid[:, None, :].expand(B, K, -1), 2, il)
    return PackedKV(pk, pv, idx, val)


def select_and_pack(q_block, k_full, v_full, *, retain: int,
                    kernel_size: int, mode: str, exclude,
                    token_valid) -> PackedKV:
    """C3 select/pack of a padded batch. q_block [B, Sb, H, dh];
    k_full/v_full [B, S, K, dh]; exclude/token_valid [B, S] bool."""
    B, S, K = k_full.shape[:3]
    if mode == "none":
        # dense retention (r = 1.0): keep everything outside the block,
        # packed by position so shapes stay static
        scores = -torch.arange(S, dtype=torch.float32,
                               device=k_full.device) * 1e-6
        scores = scores.expand(B, K, S)
        idx = select_indices(scores, retain, mode="uniform", exclude=exclude)
    else:
        scores = head_scores(q_block, k_full, kernel_size, valid=token_valid)
        idx = select_indices(scores, retain, mode=mode, exclude=exclude)
    packed = pack(idx, k_full, v_full, token_valid)
    # excluded positions may still be picked when fewer than `retain`
    # candidates exist; mark them invalid so attention masks them
    excl = torch.gather(exclude[:, None, :].expand(B, K, S), 2, idx.long())
    return PackedKV(packed.k, packed.v, packed.pos, packed.valid & ~excl)


def select_and_pack_varlen(q_block, k_flat, v_flat, seg_ids, cu_seqlens,
                           gather_rows, valid_sel, *, retain: int,
                           kernel_size: int, mode: str, exclude,
                           use_kernel: bool = True) -> PackedKV:
    """C3 select/pack reading the flat token-packed stream in place.

    q_block [R, Sb, H, dh]; k_flat/v_flat [T, K, dh]; seg_ids [T];
    cu_seqlens [R]; gather_rows/valid_sel/exclude [R, S_sel]."""
    R, S_sel = gather_rows.shape
    T, K = k_flat.shape[0], k_flat.shape[1]
    if mode == "none":
        # dense retention: position-ordered packing, no scoring
        scores = torch.zeros((R, K, S_sel), device=k_flat.device)
        scores = scores - torch.arange(
            S_sel, dtype=torch.float32, device=k_flat.device) * 1e-6
        idx = select_indices(scores, retain, mode="uniform", exclude=exclude)
    else:
        raw = head_scores_varlen(q_block, k_flat, seg_ids, kernel_size,
                                 use_kernel=use_kernel)
        rows = gather_rows[:, None, :].expand(R, K, S_sel).long()
        scores = torch.gather(raw, 2, rows)                  # [R, K, S_sel]
        idx = select_indices(scores, retain, mode=mode, exclude=exclude)
    flat_rows = (cu_seqlens[:, None, None] + idx).clamp(0, T - 1).long()
    kh = k_flat.permute(1, 0, 2)                             # [K, T, dh]
    vh = v_flat.permute(1, 0, 2)
    heads = torch.arange(K, device=k_flat.device)[None, :, None]
    pk = kh[heads, flat_rows]                                # [R, K, retain, dh]
    pv = vh[heads, flat_rows]
    il = idx.long()
    val = torch.gather(valid_sel[:, None, :].expand(R, K, S_sel), 2, il)
    excl = torch.gather(exclude[:, None, :].expand(R, K, S_sel), 2, il)
    return PackedKV(pk, pv, idx, val & ~excl)
