"""Model-layer wrappers around the kernels (``repro/kernels/ops.py``).

Each adapts the model's ``[T, H, dh]`` tensors to its kernel's head-major
layout (GQA rows token-major: row = t·G + g, query head h = k·G + g) and
back, in the caller's dtype.

Under a serving mesh whose model axis is m > 1 every wrapper runs its
kernel on this rank's shard, as the reference's ``shard_map`` does: the
attention and head-score kernels on the local ``H/m`` query and ``K/m`` KV
heads, the SSD scan on the local ``Hs/m`` state heads, the fused argmax on
the local ``V/m`` columns, whose ``(index, max, sum)`` then merge across
the model group (:func:`merge_vocab_shards`). Each wrapper enforces the
reference's divisibility law on the global dimensions it shards
(``launch.mesh.require_divisible``), as the engine does up front, except
:func:`flash_refresh_attention`, which takes the reference's fallbacks
where the heads do not divide (its docstring).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_refresh as FR
from repro_torch.kernels import flash_varlen as FV
from repro_torch.kernels import logit_argmax as LA
from repro_torch.kernels import select_pack as SP
from repro_torch.kernels import ssm_scan as SS
from repro_torch.launch import mesh as M

_HEADS = ("n_heads", "n_kv_heads")


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def merge_vocab_shards(ids, mx, s, v_local: int):
    """The cross-shard reduce of the vocab-parallel argmax (the reference's
    ``_sharded_logit_argmax``): ``ids``/``mx``/``s`` ``[n, T]`` hold each
    of n shards' local argmax, max and sum of ``exp(z - max)``, shard r
    owning columns ``[r·v_local, (r+1)·v_local)``. Returns the global
    index (the lowest among the shards that reach the max, as one device
    breaks ties), the max, and ``Σ s·exp(m - m_max)``, each ``[T]``."""
    n = ids.shape[0]
    off = torch.arange(n, device=ids.device, dtype=torch.int64)[:, None]
    gids = ids.long() + off * v_local
    m_max = mx.amax(dim=0)
    big = torch.iinfo(torch.int64).max
    gid = torch.where(mx == m_max, gids, big).amin(dim=0)
    tot = (s * torch.exp(mx - m_max)).sum(dim=0)
    return gid.to(torch.int32), m_max, tot


def gather_vocab_shards(mesh, ids, mx, s, v_local: int):
    """:func:`merge_vocab_shards` over the model group: one ``all_gather``
    of the three ``[T]`` vectors (as int32 bits), then the merge, the same
    on every rank."""
    packed = torch.stack([ids.to(torch.int32), mx.float().view(torch.int32),
                          s.float().view(torch.int32)])
    allp = mesh.stack_gather(packed, "model")               # [m, 3, T]
    return merge_vocab_shards(allp[:, 0], allp[:, 1].view(torch.float32),
                              allp[:, 2].view(torch.float32), v_local)


def fused_logit_argmax(h, w, *, softcap: float = 0.0, w_layout: str = "dv",
                       valid=None):
    """h [T, D]; w [D, V] ("dv") or [V, D] ("vd", tied table) ->
    (ids [T] int32, conf [T] f32). Paper C1, fused. Invalid rows of a
    token-bucketed stream decode to (0, 0.0). Under a model axis > 1, w is
    this rank's ``V/m`` columns and the result is the global one."""
    M.require_divisible("fused logit argmax", "vocab_size")
    T = h.shape[0]
    vld = (torch.ones((T,), dtype=torch.bool, device=h.device)
           if valid is None else valid.contiguous())
    ids, mx, s = LA.fused_logit_argmax_call(
        h.contiguous(), w, vld, softcap=softcap, w_layout=w_layout)
    mesh = M.tp()
    if mesh is not None:
        v_local = w.shape[1] if w_layout == "dv" else w.shape[0]
        ids, mx, s = gather_vocab_shards(mesh, ids, mx, s, v_local)
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
    M.require_divisible("flash varlen attention", *_HEADS)
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
    M.require_divisible("flash varlen cross attention", *_HEADS)
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


def flash_varlen_cross_pool_attention(q, k, v, *, k_pool, v_pool, pos_pool,
                                      valid_pool, slots, q_seg, q_pos,
                                      window: int = 0, is_local: bool = False,
                                      softcap: float = 0.0,
                                      causal: bool = False):
    """Packed-Reuse cross attention read in place (no mesh: the engine
    takes it only for a pool whose rows this device holds whole). q
    [Tq, H, dh] packed block queries; k/v [Tq, K, dh] the blocks' own keys
    and values; k_pool/v_pool [S1, K, Cr, dh], pos_pool/valid_pool
    [S1, K, Cr] one layer's slot pool; slots [R] each segment's pool row;
    q_seg/q_pos [Tq] -> [Tq, H, dh]."""
    Tq, H, dh = q.shape
    K = k.shape[1]
    G = H // K
    qr = q.reshape(Tq, K, G, dh).permute(1, 0, 2, 3).reshape(K, Tq * G, dh)
    out = FV.flash_varlen_cross_pool_call(
        qr.contiguous(), k.contiguous(), v.contiguous(), k_pool, v_pool,
        pos_pool, valid_pool, slots, _i32(q_pos), _i32(q_seg), is_local,
        softcap=softcap, causal=causal, window=window)
    out = out.reshape(K, Tq, G, dh).permute(1, 0, 2, 3).reshape(Tq, H, dh)
    return out.to(q.dtype)


def packed_flash_attention_stats(qr, k_all, v_all, ok, *,
                                 softcap: float = 0.0):
    """Raw flash statistics for the exact split-attention merge of the
    padded Reuse. qr [B, K, R, dh] (rows sb·G + g); k_all/v_all
    [B, K, T, dh]; ok [B, K, Sm, T] bool (Sm = Sb, or 1) -> (o f32
    UNNORMALISED [B, K, R, dh], m [B, K, R], s [B, K, R])."""
    M.require_divisible("packed flash attention", *_HEADS)
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
    [B, S, K, dh]; q_pos/kv_pos [B, S]; kv_valid [B, S] -> [B, S, H, dh].

    Under a model axis m > 1 the reference's placement, which never
    refuses: where m divides the global ``n_heads``, q holds this rank's
    ``H/m`` heads and k/v the KV heads they read (its own ``K/m``, or the
    model layer's slice of the whole ``K``:
    ``transformer.query_kv_range``); else, where m divides S, the rank
    attends query rows ``[i·S/m, (i+1)·S/m)`` against the whole K/V (each
    row's output is complete, so no sum) and the rows are gathered over
    the model axis; else every rank makes the whole call."""
    mesh = M.tp()
    S = q.shape[1]
    if mesh is not None:
        m = mesh.shape["model"]
        H = M.global_dim(mesh, "flash refresh attention", "n_heads")
        if H % m and S % m == 0:
            n = S // m
            i = mesh.index("model") * n
            out = _flash_refresh_rows(
                q.narrow(1, i, n), k, v, q_pos.narrow(1, i, n), kv_pos,
                kv_valid, mask_mode, window, is_local, softcap)
            return mesh.all_gather(out, "model", dim=1)
    return _flash_refresh_rows(q, k, v, q_pos, kv_pos, kv_valid, mask_mode,
                               window, is_local, softcap)


def _flash_refresh_rows(q, k, v, q_pos, kv_pos, kv_valid, mask_mode, window,
                        is_local, softcap):
    """Row 7 on query rows q [B, Sq, H, dh] (q_pos [B, Sq]) against k/v
    [B, S, K, dh] -> [B, Sq, H, dh]."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qr = q.reshape(B, Sq, K, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, K, Sq * G, dh)
    out = FR.flash_refresh_call(
        qr.contiguous(), k.permute(0, 2, 1, 3).contiguous(),
        v.permute(0, 2, 1, 3).contiguous(), _i32(q_pos), _i32(kv_pos),
        kv_valid.contiguous(), bool(is_local), softcap=softcap,
        causal=mask_mode == "causal", window=window)
    out = out.reshape(B, K, Sq, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, H, dh)
    return out.to(q.dtype)


def head_score(q_block, k_full):
    """q_block [B, Sb, H, dh]; k_full [B, S, K, dh] -> [B, K, S] f32 raw
    (pre-maxpool) importance scores of a padded batch. The kernel reads
    k_full in place, as its [B, K, S, dh] view."""
    M.require_divisible("head score", *_HEADS)
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
    M.require_divisible("head score varlen", *_HEADS)
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
    M.require_divisible("ssm segment scan", "ssm_heads")
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


def dequantize_gathered(gathered, kv_quant: str, dtypes):
    """The Reuse stages' KV-load dequantization point (ref ``ops.py``
    ``dequantize_gathered``). Under ``kv_quant="int8"`` the slot pool's
    gather returns the quantized view ``{"data": int8-leaf tree, "scale":
    per-leaf [L, B] float32}``; this scales the KV leaves back to
    ``dtypes`` inside the Reuse entry, so the dequantized tensors are
    transient activations of that stage, never pool state. The attention
    kernels keep their bf16/f32 contracts. ``"none"`` passes the gathered
    cache through untouched."""
    if kv_quant == "none":
        return gathered
    from repro_torch.kernels.kv_quant import dequantize_slot_leaves
    return dequantize_slot_leaves(gathered["data"], gathered["scale"],
                                  dtypes)
