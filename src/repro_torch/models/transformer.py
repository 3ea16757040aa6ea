"""Bidirectional diffusion transformer (dense and moe families): the
serving paths of ``repro.models.transformer``.

Padded paths (the oracle, and the three baseline systems):

* :func:`forward_full` — **Refresh** of a ``[B, S]`` batch: the q-chunked
  exact ``layers.attention`` (or the ``flash_refresh`` kernel under
  ``use_flash_refresh``), then select/pack of each request's retained KV,
  per layer.
* :func:`forward_block` — **Reuse**: the active blocks attend to
  ``[packed cache ; live block KV]``, by default as a split attention with
  an exact (m, s) merge; the cache half runs the ``packed_flash_attention``
  kernel under ``use_flash_kernel``.

Token-packed paths:

* :func:`forward_full_packed` — **Refresh**: one ragged ``[T]`` stream
  through the layer stack; self-attention in the varlen kernel, then
  head-centric select/pack of each request's retained KV, per layer.
* :func:`forward_block_packed` — **Reuse**: the iteration's active blocks
  as one ``[R·Sb]`` query stream against their gathered
  ``[retain ; live block]`` caches, in the varlen cross kernel.

On the card, the padded Refresh attention (without ``use_flash_refresh``)
and the live-block half of the split Reuse run as plain PyTorch, because
the reference computes them in jnp outside any Pallas kernel on the
engine's path. Everything a kernel flag selects launches its kernel; the
plain fallbacks the reference keeps beside its kernels
(``use_flash_kernel=False``) run on the CPU only. The large matrix
products are ``torch.matmul``/``einsum``.

Weights stay stacked on a leading ``[L, ...]`` axis (the reference's
layout); the reference's ``lax.scan`` over layers is a Python loop here.
An MoE arch's MLP is ``models.moe.moe_ffn``, with its capacity taken on
the ``T`` each stage runs (the engine's buckets), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.sparse_select import (PackedKV, select_and_pack,
                                              select_and_pack_varlen,
                                              take_heads)


@dataclass(frozen=True)
class ServeContext:
    """Per-step serving metadata threaded through the layer loop."""
    block_size: int
    retain: int
    kernel_size: int = 3
    selection: str = "head"        # head | uniform | none
    q_chunk: int = L.DEFAULT_Q_CHUNK
    use_flash_kernel: bool = False  # Reuse kernels; packed Refresh kernels
    reuse_concat: bool = False      # paper-naive single [cache;block] pass
    use_flash_refresh: bool = False  # flash_refresh kernel, padded Refresh
    max_seq_len: int = 0            # per-request L cap (packed Refresh)
    # the mesh axes that cut a Reuse cache's retained length (``Rules``'
    # ``packed_kv``: the data axes at batch 1, ``model`` where the KV heads
    # do not divide it); () where it is whole
    kv_split: tuple = ()


def _check_kernel_path(serve: ServeContext, device) -> None:
    """The kernel flags select kernels; the plain fallbacks beside them run
    on the CPU only, for every family."""
    if serve.use_flash_kernel:
        return
    if torch.device(device).type == "cuda":
        raise ValueError(
            "on CUDA the serving stages run their kernels: set "
            "use_flash_kernel=True (the plain fallbacks run on the CPU only)")


def kv_heads(p) -> int:
    """The KV heads a (stacked or one-layer) attention weight set computes:
    ``K``, or ``K/m`` on a rank whose model axis divides them."""
    return p["wk"].shape[-2]


def layer_params(stack, l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s slice of the stacked ``[L, ...]`` weights, for code
    that visits one layer at a time with frozen weights (the serving stages
    and decode loops). Code under autograd that walks every layer takes
    :func:`layer_slices`."""
    return {name: t[l] for name, t in stack.items()}


def layer_slices(stack) -> List[Dict[str, torch.Tensor]]:
    """Every layer's slice of the stacked ``[L, ...]`` weights, as views
    from one ``unbind`` a tensor: under autograd each stacked weight gets
    one gradient of its whole ``[L, ...]`` shape, where a slice a layer
    (:func:`layer_params`) would give L zero-filled ones to sum."""
    names = [name for name, _ in stack.items()]
    per_name = [t.unbind(0) for _, t in stack.items()]
    return [dict(zip(names, ts)) for ts in zip(*per_name)]


def _qkv(p, x, cfg: ModelConfig, cos, sin):
    q = torch.einsum("...d,dhe->...he", x, p["wq"])
    k = torch.einsum("...d,dke->...ke", x, p["wk"])
    v = torch.einsum("...d,dke->...ke", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    return q, k, v


def query_kv_range(n_q: int, n_kv: int, cfg: ModelConfig):
    """The KV heads this rank's ``n_q`` query heads read, where the model
    axis splits the query heads and not the ``n_kv`` KV heads: the global
    KV-head index of each local KV slot, the reference's slice of
    ``max(1, n_q // G)`` heads from ``index · n_q // G``
    (``repro.kernels.ops.flash_refresh_attention``) where the rank's heads
    fill whole groups or lie in one, else one slot a query head (its
    heads straddle the groups unevenly: ``G = 1`` on the rank). None
    where the query and KV heads pair up already: both whole, or both the
    rank's shards."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    if n_q == H or n_kv < K:
        return None
    G = H // K
    h0 = L.tp_index() * n_q
    if n_q % G == 0 or G % n_q == 0:
        return tuple(range(h0 // G, h0 // G + max(1, n_q // G)))
    return tuple((h0 + j) // G for j in range(n_q))


def _heads(kr, *ts, dim: int):
    """Each of ``ts`` on the KV heads ``kr`` (on ``dim``)."""
    return tuple(take_heads(t, kr, dim) for t in ts)


def _mlp(p, x, cfg: ModelConfig):
    """Returns (y, aux_loss); dense MLPs have zero aux. A rank holding
    ``d_ff/m`` of the hidden (column-parallel ``w_gate``/``w_up``,
    row-parallel ``w_down``) sums its partial output over the model
    axis."""
    if cfg.is_moe:
        return moe_lib.moe_ffn(p, x, cfg)
    y = L.gated_mlp(x, p["w_gate"], p["w_up"], p["w_down"], cfg.activation)
    if p["w_down"].shape[-2] < cfg.d_ff:
        y = L.tp_sum(y)
    return y, 0.0


def _attn_out(attn, wo, cfg: ModelConfig):
    """[..., Hl, dh] x [Hl, dh, D] -> [..., D]. A rank holding ``H/m`` rows
    of ``wo`` (row-parallel) projects its own heads and sums over the model
    axis."""
    y = attn.flatten(-2) @ wo.flatten(0, 1)
    return L.tp_sum(y) if wo.shape[0] < cfg.n_heads else y


def slice_block(h: torch.Tensor, block_start: torch.Tensor,
                Sb: int) -> torch.Tensor:
    """Rows ``[block_start, block_start + Sb)`` of each batch row of
    h [B, S, ...] (starts clamped in bounds, as ``dynamic_slice`` does)."""
    S = h.shape[1]
    ar = torch.arange(Sb, device=h.device)
    rows = block_start.long().clamp(0, S - Sb)[:, None] + ar[None]
    idx = rows.reshape(rows.shape + (1,) * (h.dim() - 2))
    return torch.gather(h, 1, idx.expand((-1, -1) + tuple(h.shape[2:])))


def _layer_full(p, x, cfg: ModelConfig, positions, cos, sin,
                is_local: bool, token_valid, mask_mode: str,
                serve: Optional[ServeContext], block_start):
    """One padded Refresh layer. x [B, S, D] -> (x, PackedKV | None, aux)."""
    h = L.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(p, h, cfg, cos, sin)
    kr = query_kv_range(q.shape[-2], k.shape[-2], cfg)
    ka, va = _heads(kr, k, v, dim=-2)
    attn = L.attention(
        q, ka, va, q_pos=positions, kv_pos=positions, kv_valid=token_valid,
        mask_mode=mask_mode, window=cfg.sliding_window, is_local=is_local,
        attn_softcap=cfg.attn_softcap,
        q_chunk=serve.q_chunk if serve else L.DEFAULT_Q_CHUNK,
        use_kernel=bool(serve and serve.use_flash_refresh))
    x = x + _attn_out(attn, p["wo"], cfg)
    h2 = L.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    y, aux = _mlp(p, h2, cfg)
    x = x + y
    packed = None
    if serve is not None:
        Sb = serve.block_size
        S = positions.shape[1]
        qb = slice_block(q, block_start, Sb)          # [B, Sb, H, dh]
        ar = torch.arange(S, device=x.device)
        in_block = (ar[None] >= block_start[:, None]) & \
                   (ar[None] < block_start[:, None] + Sb)
        packed = select_and_pack(
            qb, k, v, retain=serve.retain, kernel_size=serve.kernel_size,
            mode=serve.selection, exclude=in_block | ~token_valid,
            token_valid=token_valid, kv_range=kr)
    return x, packed, aux


def forward_full(stack, cfg: ModelConfig, x, positions, *,
                 token_valid=None, mask_mode: str = "bidirectional",
                 serve: Optional[ServeContext] = None, block_start=None,
                 remat: bool = False):
    """Padded full-sequence forward over the layer stack: the padded
    Refresh, and the training forward. x [B, S, D]; positions [B, S];
    token_valid [B, S]; block_start [B]. With ``serve`` each layer selects
    and packs its retained KV. ``remat`` (the training forward) recomputes
    each layer in backward, as the reference checkpoints its scan body.
    Returns (hidden [B, S, D], PackedKV with a leading [L] axis or None,
    aux: the mean of the layers' MoE aux losses)."""
    B, S, _ = x.shape
    if token_valid is None:
        token_valid = torch.ones((B, S), dtype=torch.bool, device=x.device)
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    flags = L.layer_flags(cfg)
    nl = cfg.n_layers
    out = None
    if serve is not None:
        K, dh, ret = kv_heads(stack), cfg.resolved_head_dim, serve.retain
        out = PackedKV(
            torch.empty((nl, B, K, ret, dh), dtype=x.dtype, device=x.device),
            torch.empty((nl, B, K, ret, dh), dtype=x.dtype, device=x.device),
            torch.empty((nl, B, K, ret), dtype=torch.int32, device=x.device),
            torch.empty((nl, B, K, ret), dtype=torch.bool, device=x.device))
    aux = 0.0
    for l, p in enumerate(layer_slices(stack)):
        args = (p, x, cfg, positions, cos, sin, flags[l], token_valid,
                mask_mode, serve, block_start)
        x, packed, aux_l = (L.remat(_layer_full, *args) if remat
                            else _layer_full(*args))
        aux = aux + aux_l
        if out is not None:
            for dst, src in zip(out, packed):
                dst[l] = src
    return x, out, aux / nl


def _attend_packed_stream(q, k, v, positions, seg_ids, token_valid,
                          cfg: ModelConfig, is_local: bool,
                          serve: ServeContext,
                          mask_mode: str = "bidirectional"):
    """Segment-masked attention over the flat packed stream: the plain
    fallback beside the varlen kernel (CPU only). q [1, T, H, dh]; k/v
    [1, T, K, dh]; positions/seg_ids/token_valid [1, T]. Requests are
    contiguous and at most ``max_seq_len`` long, so a ``q_chunk`` query slab
    attends only to a ``q_chunk + 2·max_seq_len`` window around it."""
    _, T_len, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    c = min(serve.q_chunk, T_len)
    win = min(T_len, c + 2 * serve.max_seq_len)
    if T_len % c or win >= T_len:
        # the window covers everything (or ragged chunking): segment path
        return L.attention(
            q, k, v, q_pos=positions, kv_pos=positions,
            kv_valid=token_valid, q_seg=seg_ids, kv_seg=seg_ids,
            mask_mode=mask_mode, window=cfg.sliding_window,
            is_local=is_local, attn_softcap=cfg.attn_softcap, q_chunk=c)
    scale = dh ** -0.5
    pos, seg, val = positions[0], seg_ids[0], token_valid[0]
    # window start: the first token of the chunk's first segment, clamped
    # so the fixed-size window stays in bounds
    starts = torch.arange(0, T_len, c, device=q.device)
    if q.device.type == "meta":
        # the dry run's shapes: the window's size is fixed, its start is not
        # needed
        w0 = [0] * starts.shape[0]
    else:
        # the plain path, CPU only (the card runs flash_varlen): a host read
        w0 = (starts - pos[starts]).clamp(0, T_len - win)
        w0 = w0.tolist()  # lint: allow(host-sync)
    outs = []
    for i, w in enumerate(w0):
        qc = q[0, i * c: (i + 1) * c].reshape(c, K, G, dh)
        qp, qs = pos[i * c: (i + 1) * c], seg[i * c: (i + 1) * c]
        kc, vc = k[0, w: w + win], v[0, w: w + win]
        kp, ks, kv = pos[w: w + win], seg[w: w + win], val[w: w + win]
        z = torch.einsum("qkgd,skd->kgqs", qc, kc).float() * scale
        if cfg.attn_softcap:
            z = cfg.attn_softcap * torch.tanh(z / cfg.attn_softcap)
        ok = (qs[:, None] == ks[None, :]) & kv[None, :]
        if mask_mode == "causal":
            ok = ok & (qp[:, None] >= kp[None, :])
        if cfg.sliding_window and is_local:
            ok = ok & ((qp[:, None] - kp[None, :]).abs()
                       <= cfg.sliding_window)
        z = z.masked_fill(~ok[None, None], -1e30)
        p = torch.softmax(z, dim=-1).to(vc.dtype)
        outs.append(torch.einsum("kgqs,skd->qkgd", p, vc))
    return torch.cat(outs).reshape(1, T_len, H, dh).to(q.dtype)


def _layer_full_packed(p, x, cfg: ModelConfig, positions, seg_ids,
                       token_valid, cos, sin, is_local: bool,
                       serve: ServeContext, cu_seqlens, gather_rows,
                       valid_sel, block_rows, in_block,
                       mask_mode: str = "bidirectional"):
    """One packed Refresh layer. x [1, T, D] -> (x, PackedKV, aux)."""
    h = L.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(p, h, cfg, cos, sin)
    kr = query_kv_range(q.shape[-2], k.shape[-2], cfg)
    ka, va = _heads(kr, k, v, dim=-2)
    use_kernel = serve.use_flash_refresh or serve.use_flash_kernel
    if use_kernel:
        attn = ops.flash_varlen_attention(
            q[0], ka[0], va[0], seg_ids=seg_ids[0], positions=positions[0],
            kv_valid=token_valid[0], window=cfg.sliding_window,
            is_local=is_local, causal=mask_mode == "causal",
            softcap=cfg.attn_softcap)[None]
    else:
        attn = _attend_packed_stream(q, ka, va, positions, seg_ids,
                                     token_valid, cfg, is_local, serve,
                                     mask_mode=mask_mode)
    x = x + _attn_out(attn, p["wo"], cfg)
    h2 = L.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    y, aux = _mlp(p, h2, cfg)
    x = x + y
    qb = q[0][block_rows.long()]           # [R, Sb, H, dh]
    packed = select_and_pack_varlen(
        qb, k[0], v[0], seg_ids[0], cu_seqlens, gather_rows, valid_sel,
        retain=serve.retain, kernel_size=serve.kernel_size,
        mode=serve.selection, exclude=in_block | ~valid_sel,
        use_kernel=use_kernel, kv_range=kr)
    return x, packed, aux


def packed_block_rows(cu_seqlens, block_start, block_size: int,
                      total_len: int):
    """Flat stream rows of each request's active block ([R, Sb], clipped so
    padding requests gather in-bounds)."""
    ar = torch.arange(block_size, dtype=torch.int32, device=cu_seqlens.device)
    return (cu_seqlens[:, None] + block_start[:, None] + ar[None]).clamp(
        0, total_len - 1)


def packed_refresh_geometry(cu_seqlens, seq_lens, block_start, total_len,
                            serve: ServeContext):
    """(gather_rows [R, S_sel], valid_sel [R, S_sel], block_rows [R, Sb],
    in_block [R, S_sel]) of a packed Refresh stream."""
    S_sel = serve.max_seq_len
    Sb = serve.block_size
    ar = torch.arange(S_sel, dtype=torch.int32, device=cu_seqlens.device)
    gather_rows = (cu_seqlens[:, None] + ar[None]).clamp(0, total_len - 1)
    valid_sel = ar[None] < seq_lens[:, None]
    block_rows = packed_block_rows(cu_seqlens, block_start, Sb, total_len)
    in_block = (ar[None] >= block_start[:, None]) & \
               (ar[None] < block_start[:, None] + Sb)
    return gather_rows, valid_sel, block_rows, in_block


def forward_full_packed(stack, cfg: ModelConfig, x, positions, seg_ids,
                        token_valid, cu_seqlens, seq_lens, block_start,
                        serve: ServeContext):
    """Token-packed Refresh over the layer stack.

    x [1, T, D]; positions/seg_ids/token_valid [1, T]; cu_seqlens/seq_lens/
    block_start [R]. Returns (hidden [1, T, D], PackedKV with a leading [L]
    axis, aux)."""
    assert serve.max_seq_len > 0, "packed path needs ServeContext.max_seq_len"
    _check_kernel_path(serve, x.device)
    T = x.shape[1]
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    flags = L.layer_flags(cfg)
    geom = packed_refresh_geometry(cu_seqlens, seq_lens, block_start, T, serve)
    R, nl = cu_seqlens.shape[0], cfg.n_layers
    K, dh = kv_heads(stack), cfg.resolved_head_dim
    dev = x.device
    out = PackedKV(
        torch.empty((nl, R, K, serve.retain, dh), dtype=x.dtype, device=dev),
        torch.empty((nl, R, K, serve.retain, dh), dtype=x.dtype, device=dev),
        torch.empty((nl, R, K, serve.retain), dtype=torch.int32, device=dev),
        torch.empty((nl, R, K, serve.retain), dtype=torch.bool, device=dev))
    aux = 0.0
    for l in range(nl):
        x, packed, aux_l = _layer_full_packed(
            layer_params(stack, l), x, cfg, positions, seg_ids, token_valid,
            cos, sin, flags[l], serve, cu_seqlens, *geom)
        aux = aux + aux_l
        for dst, src in zip(out, packed):
            dst[l] = src
    return x, out, aux / nl


def forward_block_packed(stack, cfg: ModelConfig, xb, block_positions,
                         cache: PackedKV, *, serve: ServeContext):
    """Token-packed Reuse over the layer stack. xb [R, Sb, D];
    block_positions [R, Sb]; cache fields [L, R, K, retain(, dh)]. Without
    ``use_flash_kernel`` each layer runs the split-attention fallback over
    the same R requests (CPU only)."""
    _check_kernel_path(serve, xb.device)
    R, Sb, _ = xb.shape
    cos, sin = L.rope_tables(block_positions, cfg.resolved_head_dim,
                             cfg.rope_theta)
    flags = L.layer_flags(cfg)
    Cr = cache.k.shape[3]
    ar = torch.arange(R, dtype=torch.int32, device=xb.device)
    q_seg = ar.repeat_interleave(Sb)
    kv_seg = ar.repeat_interleave(Cr + Sb)
    for l in range(cfg.n_layers):
        p = layer_params(stack, l)
        if serve.use_flash_kernel:
            xb = _reuse_attention_layer_flat(
                p, xb, cfg, cos, sin, block_positions, flags[l], cache.k[l],
                cache.v[l], cache.pos[l], cache.valid[l], q_seg, kv_seg,
                kv_split=serve.kv_split)
        else:
            xb = reuse_attention_layer(
                p, xb, cfg, cos, sin, block_positions, flags[l], cache.k[l],
                cache.v[l], cache.pos[l], cache.valid[l], "bidirectional",
                concat=serve.reuse_concat, kv_split=serve.kv_split)
        h2 = L.rms_norm(xb, p["mlp_norm"], cfg.rms_eps)
        y, _ = _mlp(p, h2, cfg)
        xb = xb + y
    return xb


def _reuse_attention_layer_flat(p, x, cfg: ModelConfig, cos, sin,
                                block_positions, is_local: bool, ck, cv,
                                cpos, cvalid, q_seg, kv_seg,
                                mask_mode: str = "bidirectional",
                                kv_split: tuple = ()):
    """One packed-Reuse attention sublayer as a single flat varlen dispatch.

    x [R, Sb, D]; ck/cv [R, K, Cr, dh] gathered slot caches. The KV stream
    interleaves each request's retained cache with its live block KV, so
    requests stay contiguous (segment-ascending). One pass over the whole
    retained length: a cut one is refused (:func:`_whole_retained`)."""
    _whole_retained(kv_split, "the flat varlen Reuse kernel")
    R, Sb, _ = x.shape
    K, Cr, dh = ck.shape[1], ck.shape[2], ck.shape[3]
    h = L.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(p, h, cfg, cos, sin)
    H = q.shape[2]
    kb = k.transpose(1, 2)                                  # [R, K, Sb, dh]
    vb = v.transpose(1, 2)
    bpos_hm = block_positions[:, None].expand(R, K, Sb)
    k_all = torch.cat([ck, kb], dim=2)                      # [R, K, Cr+Sb, dh]
    v_all = torch.cat([cv, vb], dim=2)
    pos_all = torch.cat([cpos, bpos_hm.to(cpos.dtype)], dim=2)
    valid_all = torch.cat(
        [cvalid, torch.ones((R, K, Sb), dtype=torch.bool, device=x.device)],
        dim=2)
    Tkv = R * (Cr + Sb)
    k_s = k_all.transpose(0, 1).reshape(K, Tkv, dh)
    v_s = v_all.transpose(0, 1).reshape(K, Tkv, dh)
    pos_s = pos_all.transpose(0, 1).reshape(K, Tkv)
    valid_s = valid_all.transpose(0, 1).reshape(K, Tkv)
    out = ops.flash_varlen_cross_attention(
        q.reshape(R * Sb, H, dh), k_s, v_s,
        q_seg=q_seg, q_pos=block_positions.reshape(-1),
        kv_seg=kv_seg, kv_pos=pos_s, kv_valid=valid_s,
        window=cfg.sliding_window, is_local=is_local,
        causal=mask_mode == "causal", softcap=cfg.attn_softcap)
    return x + _attn_out(out.reshape(R, Sb, H, dh), p["wo"], cfg)


def forward_block(stack, cfg: ModelConfig, xb, block_positions,
                  cache: PackedKV, *, serve: ServeContext,
                  mask_mode: str = "bidirectional"):
    """Padded Reuse over the layer stack. xb [B, Sb, D]; block_positions
    [B, Sb]; cache fields [L, B, K, retain(, dh)]."""
    _check_kernel_path(serve, xb.device)
    cos, sin = L.rope_tables(block_positions, cfg.resolved_head_dim,
                             cfg.rope_theta)
    flags = L.layer_flags(cfg)
    for l in range(cfg.n_layers):
        p = layer_params(stack, l)
        xb = reuse_attention_layer(
            p, xb, cfg, cos, sin, block_positions, flags[l], cache.k[l],
            cache.v[l], cache.pos[l], cache.valid[l], mask_mode,
            use_kernel=serve.use_flash_kernel, concat=serve.reuse_concat,
            kv_split=serve.kv_split)
        h2 = L.rms_norm(xb, p["mlp_norm"], cfg.rms_eps)
        y, _ = _mlp(p, h2, cfg)
        xb = xb + y
    return xb


def reuse_attention_layer(p, x, cfg: ModelConfig, cos, sin, block_positions,
                          is_local: bool, ck, cv, cpos, cvalid,
                          mask_mode: str, use_kernel: bool = False,
                          concat: bool = False, kv_split: tuple = ()):
    """One Reuse attention sublayer over [packed cache ; live block KV].

    Default (``concat=False``): split attention, one pass over the packed
    cache (the ``packed_flash_attention`` kernel under ``use_kernel``) and
    one over the live block's KV (plain PyTorch), merged exactly with their
    (m, s) statistics. ``concat=True`` is the paper-naive single pass over
    the concatenation. x [B, Sb, D]; ck/cv [B, K, Cr, dh]; cpos/cvalid
    [B, K, Cr].

    On a mesh whose ``kv_split`` axes cut the retained length, ``Cr`` is
    this rank's shard: its cache half's ``(o, m, s)`` merge across those
    axes (:func:`_merge_stats`) before the live half, which every rank
    computes alike, merges locally. Where this rank's query heads are a
    split of the whole KV heads' (``query_kv_range``), a cache cut over
    ``model`` serves every query head, so the block's queries are gathered
    (``Sb`` rows) and the result cut back to the rank's heads; a cache the
    model axis leaves whole is read on the rank's KV-head slice."""
    h = L.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(p, h, cfg, cos, sin)
    Hl = q.shape[2]
    kr = query_kv_range(Hl, k.shape[-2], cfg)
    own = None
    if kr is not None and "model" in kv_split:
        own = L.tp_index() * Hl
        q = L.tp_gather(q, -2)
    else:
        k, v = _heads(kr, k, v, dim=-2)
        ck, cv, cpos, cvalid = _heads(kr, ck, cv, cpos, cvalid, dim=1)
    kb = k.transpose(1, 2)                              # [B, K, Sb, dh]
    vb = v.transpose(1, 2)
    bpos_hm = block_positions[:, None].expand(kb.shape[:3]).to(cpos.dtype)
    live = torch.ones(kb.shape[:3], dtype=torch.bool, device=x.device)
    if concat:
        _whole_retained(kv_split, "the concatenated Reuse pass")
        attn = _attend_packed(
            q, torch.cat([ck, kb], dim=2), torch.cat([cv, vb], dim=2),
            torch.cat([cpos, bpos_hm], dim=2),
            torch.cat([cvalid, live], dim=2), block_positions, is_local, cfg,
            mask_mode, use_kernel=use_kernel)
    else:
        ok_c = _reuse_mask(cvalid, cpos, block_positions, is_local, cfg,
                           mask_mode)
        ok_b = _reuse_mask(live, bpos_hm, block_positions, is_local, cfg,
                           mask_mode)
        B, Sb, H, dh = q.shape
        K = ck.shape[1]
        G = H // K
        if use_kernel:
            qr = q.reshape(B, Sb, K, G, dh).permute(0, 2, 1, 3, 4).reshape(
                B, K, Sb * G, dh)
            o1, m1, s1 = ops.packed_flash_attention_stats(
                qr, ck, cv, ok_c, softcap=cfg.attn_softcap)
            o1 = o1.reshape(B, K, Sb, G, dh).transpose(2, 3)
            m1 = m1.reshape(B, K, Sb, G).transpose(2, 3)
            s1 = s1.reshape(B, K, Sb, G).transpose(2, 3)
        else:
            o1, m1, s1 = _attend_stats(q, ck, cv, ok_c, cfg)
        o1, m1, s1 = _merge_stats(o1, m1, s1, kv_split)
        o2, m2, s2 = _attend_stats(q, kb, vb, ok_b, cfg)
        m = torch.maximum(m1, m2)
        a1 = torch.exp(m1 - m)[..., None]
        a2 = torch.exp(m2 - m)[..., None]
        den = s1[..., None] * a1 + s2[..., None] * a2
        out = (o1 * a1 + o2 * a2) / den.clamp_min(1e-30)   # [B,K,G,Sb,dh]
        attn = out.permute(0, 3, 1, 2, 4).reshape(B, Sb, H, dh).to(q.dtype)
    if own is not None:
        attn = attn[:, :, own: own + Hl]
    return x + _attn_out(attn, p["wo"], cfg)


def _whole_retained(kv_split: tuple, what: str) -> None:
    """A Reuse pass over ``[cache ; block]`` at once has no cross-rank
    merge of the cache's statistics: on a retained length that ``kv_split``
    cuts it would attend this rank's shard alone, so it is refused with
    the documented divisibility wording."""
    if kv_split:
        raise ValueError(
            f"{what} cannot partition over the {'+'.join(kv_split)} "
            "axes that cut the retained length (use the split Reuse: "
            "reuse_concat=False, and the padded or plain packed path)")


def _merge_stats(o, m, s, kv_split: tuple):
    """The unnormalised flash statistics of the whole retained length from
    each rank's over its shard: ``M = max m``, then ``Σ o·exp(m − M)`` and
    ``Σ s·exp(m − M)`` over the ``kv_split`` axes (row 2's split merge,
    across ranks). A shard with no valid key has ``m = -1e30`` and adds
    nothing. Unchanged where nothing cuts the retained length."""
    if not kv_split:
        return o, m, s
    mesh = M.active()
    mx = mesh.all_reduce(m, kv_split, op="max")
    a = torch.exp(m - mx)
    return (mesh.all_reduce(o * a[..., None], kv_split),
            mx, mesh.all_reduce(s * a, kv_split))


def _reuse_mask(valid, pos_hm, q_pos, is_local: bool, cfg: ModelConfig,
                mask_mode: str):
    """[B, K, Sb or 1, T] boolean mask for one side of the split attention
    (the query axis stays 1 when no mask term depends on the query)."""
    ok = valid[:, :, None, :]
    if mask_mode == "causal":
        ok = ok & (q_pos[:, None, :, None] >= pos_hm[:, :, None, :])
    if cfg.sliding_window and is_local:
        dist = (q_pos[:, None, :, None] - pos_hm[:, :, None, :]).abs()
        ok = ok & (dist <= cfg.sliding_window)
    return ok


def _attend_stats(q, k_hm, v_hm, ok, cfg: ModelConfig):
    """Unnormalised flash statistics for the exact merge. q [B, Sb, H, dh];
    k_hm/v_hm [B, K, T, dh]; ok [B, K, Sb or 1, T]. Returns (o f32
    [B, K, G, Sb, dh], m [B, K, G, Sb], s [B, K, G, Sb]); a row with no
    key gets o = 0, s = 0 and m = -1e30."""
    B, Sb, H, dh = q.shape
    K = k_hm.shape[1]
    qg = q.reshape(B, Sb, K, H // K, dh)
    z = torch.einsum("bqkgd,bktd->bkgqt", qg, k_hm).float() * dh ** -0.5
    if cfg.attn_softcap:
        z = cfg.attn_softcap * torch.tanh(z / cfg.attn_softcap)
    z = z.masked_fill(~ok[:, :, None], float("-inf"))
    m = z.amax(dim=-1)
    finite = torch.isfinite(m)
    p = torch.exp(z - torch.where(finite, m, 0.0)[..., None])
    p = torch.where(torch.isfinite(z), p, 0.0)
    o = torch.einsum("bkgqt,bktd->bkgqd", p.to(v_hm.dtype), v_hm)
    return o.float(), torch.where(finite, m, -1e30), p.sum(dim=-1)


def _attend_packed(q, k_all, v_all, pos_all, valid_all, q_pos,
                   is_local: bool, cfg: ModelConfig,
                   mask_mode: str = "bidirectional",
                   use_kernel: bool = False):
    """Reuse attention of [B, Sb, H, dh] queries over head-major packed KV
    k_all/v_all [B, K, T, dh] (pos_all/valid_all [B, K, T]) in one pass;
    ``use_kernel`` runs the ``packed_flash_attention`` kernel."""
    B, Sb, H, dh = q.shape
    K = k_all.shape[1]
    ok = _reuse_mask(valid_all, pos_all, q_pos, is_local, cfg, mask_mode)
    if use_kernel:
        return ops.packed_flash_attention(q, k_all, v_all, ok,
                                          softcap=cfg.attn_softcap)
    qg = q.reshape(B, Sb, K, H // K, dh)
    z = torch.einsum("bqkgd,bktd->bkgqt", qg, k_all).float() * dh ** -0.5
    if cfg.attn_softcap:
        z = cfg.attn_softcap * torch.tanh(z / cfg.attn_softcap)
    z = z.masked_fill(~ok[:, :, None], -1e30)
    p = torch.softmax(z, dim=-1).to(v_all.dtype)
    return torch.einsum("bkgqt,bktd->bqkgd", p, v_all).reshape(B, Sb, H, dh)
