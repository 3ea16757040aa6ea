"""Bidirectional diffusion transformer, packed serving paths (dense family).

The token-packed halves of ``repro.models.transformer``:

* :func:`forward_full_packed` — **Refresh**: one ragged ``[T]`` stream
  through the layer stack; self-attention in the varlen kernel, then
  head-centric select/pack of each request's retained KV, per layer.
* :func:`forward_block_packed` — **Reuse**: the iteration's active blocks
  as one ``[R·Sb]`` query stream against their gathered
  ``[retain ; live block]`` caches, in the varlen cross kernel.

Weights stay stacked on a leading ``[L, ...]`` axis (the reference's
layout); the reference's ``lax.scan`` over layers is a Python loop here.
MoE, and the jnp attention fallbacks the reference keeps beside its
kernels, are not ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.sparse_select import PackedKV, select_and_pack_varlen


@dataclass(frozen=True)
class ServeContext:
    """Per-step serving metadata threaded through the layer loop."""
    block_size: int
    retain: int
    kernel_size: int = 3
    selection: str = "head"        # head | uniform | none
    use_flash_kernel: bool = False  # varlen kernels in Refresh and Reuse
    max_seq_len: int = 0            # per-request L cap (packed Refresh)


def _check_kernel_path(cfg: ModelConfig, serve: ServeContext) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP Queue A, 'MoE and "
            "frontends')")
    if not serve.use_flash_kernel:
        raise NotImplementedError(
            "the port runs the packed stages through their kernels only; the "
            "reference's jnp attention fallbacks are not ported (ROADMAP "
            "Queue A, 'the padded oracle path'). Set use_flash_kernel=True.")


def layer_params(stack, l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s slice of the stacked ``[L, ...]`` weights."""
    return {name: t[l] for name, t in stack.items()}


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


def _mlp(p, x, cfg: ModelConfig):
    """Returns (y, aux_loss); dense MLPs have zero aux."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    y = L.gated_mlp(x, p["w_gate"], p["w_up"], p["w_down"], cfg.activation)
    return y, 0.0


def _attn_out(attn, wo):
    """[..., H, dh] x [H, dh, D] -> [..., D]."""
    return attn.flatten(-2) @ wo.flatten(0, 1)


def _layer_full_packed(p, x, cfg: ModelConfig, positions, seg_ids,
                       token_valid, cos, sin, is_local: bool,
                       serve: ServeContext, cu_seqlens, gather_rows,
                       valid_sel, block_rows, in_block,
                       mask_mode: str = "bidirectional"):
    """One packed Refresh layer. x [1, T, D] -> (x, PackedKV, aux)."""
    h = L.rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(p, h, cfg, cos, sin)
    attn = ops.flash_varlen_attention(
        q[0], k[0], v[0], seg_ids=seg_ids[0], positions=positions[0],
        kv_valid=token_valid[0], window=cfg.sliding_window,
        is_local=is_local, causal=mask_mode == "causal",
        softcap=cfg.attn_softcap)[None]
    x = x + _attn_out(attn, p["wo"])
    h2 = L.rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    y, aux = _mlp(p, h2, cfg)
    x = x + y
    qb = q[0][block_rows.long()]           # [R, Sb, H, dh]
    packed = select_and_pack_varlen(
        qb, k[0], v[0], seg_ids[0], cu_seqlens, gather_rows, valid_sel,
        retain=serve.retain, kernel_size=serve.kernel_size,
        mode=serve.selection, exclude=in_block | ~valid_sel)
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
    _check_kernel_path(cfg, serve)
    T = x.shape[1]
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    flags = L.layer_flags(cfg)
    geom = packed_refresh_geometry(cu_seqlens, seq_lens, block_start, T, serve)
    R, nl = cu_seqlens.shape[0], cfg.n_layers
    K, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    dev = x.device
    out = PackedKV(
        torch.empty((nl, R, K, serve.retain, dh), dtype=x.dtype, device=dev),
        torch.empty((nl, R, K, serve.retain, dh), dtype=x.dtype, device=dev),
        torch.empty((nl, R, K, serve.retain), dtype=torch.int32, device=dev),
        torch.empty((nl, R, K, serve.retain), dtype=torch.bool, device=dev))
    for l in range(nl):
        x, packed, _ = _layer_full_packed(
            layer_params(stack, l), x, cfg, positions, seg_ids, token_valid,
            cos, sin, flags[l], serve, cu_seqlens, *geom)
        for dst, src in zip(out, packed):
            dst[l] = src
    return x, out, 0.0


def forward_block_packed(stack, cfg: ModelConfig, xb, block_positions,
                         cache: PackedKV, *, serve: ServeContext):
    """Token-packed Reuse over the layer stack. xb [R, Sb, D];
    block_positions [R, Sb]; cache fields [L, R, K, retain(, dh)]."""
    _check_kernel_path(cfg, serve)
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
        xb = _reuse_attention_layer_flat(
            p, xb, cfg, cos, sin, block_positions, flags[l], cache.k[l],
            cache.v[l], cache.pos[l], cache.valid[l], q_seg, kv_seg)
        h2 = L.rms_norm(xb, p["mlp_norm"], cfg.rms_eps)
        y, _ = _mlp(p, h2, cfg)
        xb = xb + y
    return xb


def _reuse_attention_layer_flat(p, x, cfg: ModelConfig, cos, sin,
                                block_positions, is_local: bool, ck, cv,
                                cpos, cvalid, q_seg, kv_seg,
                                mask_mode: str = "bidirectional"):
    """One packed-Reuse attention sublayer as a single flat varlen dispatch.

    x [R, Sb, D]; ck/cv [R, K, Cr, dh] gathered slot caches. The KV stream
    interleaves each request's retained cache with its live block KV, so
    requests stay contiguous (segment-ascending)."""
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
    return x + _attn_out(out.reshape(R, Sb, H, dh), p["wo"])
