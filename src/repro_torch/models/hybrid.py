"""Zamba2-style hybrid backbone, packed serving paths of
``repro.models.hybrid``: a Mamba2 stack and one *shared* attention block.

``n_layers`` Mamba2 layers form groups of ``shared_attn_interval``; after
each group the single weight-tied attention+MLP block runs, causal. The
remaining layers form a tail. The reference's ``lax.scan`` over groups is
index arithmetic over the stacked ``[L]`` axis here.

Serving caches: per Mamba layer the recurrent state and conv history at
``block_start``; per shared-block invocation the head-centric packed KV.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.sparse_select import PackedKV


class HybridCache(NamedTuple):
    ssm_state: torch.Tensor   # [Lm, B, H, P, N] float32
    conv: torch.Tensor        # [Lm, B, ck-1, ch]
    kv: PackedKV              # leading [n_invocations] axis


def group_shape(cfg: ModelConfig) -> Tuple[int, int, int]:
    itv = cfg.shared_attn_interval
    n_groups = cfg.n_layers // itv
    return n_groups, itv, cfg.n_layers - n_groups * itv


def _split_groups(cfg: ModelConfig):
    """Mamba layer indices of each group, then of the tail."""
    n_groups, itv, _ = group_shape(cfg)
    groups = [range(g * itv, (g + 1) * itv) for g in range(n_groups)]
    return groups, range(n_groups * itv, cfg.n_layers)


def forward_full_packed(params, cfg: ModelConfig, x, positions, seg_ids,
                        token_valid, cu_seqlens, seq_lens, block_start,
                        serve: T.ServeContext):
    """Token-packed hybrid Refresh: the Mamba2 layers run the segment-reset
    scan with per-request capture, the shared block the causal varlen
    attention with in-place select/pack. x [1, T, D]; positions/seg_ids/
    token_valid [1, T]; cu_seqlens/seq_lens/block_start [R]. Returns
    (hidden [1, T, D], :class:`HybridCache`)."""
    assert serve.max_seq_len > 0, "packed path needs ServeContext.max_seq_len"
    T._check_kernel_path(cfg, serve, x.device)
    T_len = x.shape[1]
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    geom = T.packed_refresh_geometry(cu_seqlens, seq_lens, block_start, T_len,
                                     serve)
    mamba, shared = params["mamba"], params["shared"]
    groups, tail = _split_groups(cfg)
    R, dev = cu_seqlens.shape[0], x.device
    K, dh, ret = cfg.n_kv_heads, cfg.resolved_head_dim, serve.retain
    state = torch.empty((cfg.n_layers, R, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=dev)
    conv = torch.empty((cfg.n_layers, R, cfg.ssm_conv_kernel - 1,
                        S.conv_channels(cfg)), dtype=x.dtype, device=dev)
    ng = len(groups)
    kv = PackedKV(
        torch.empty((ng, R, K, ret, dh), dtype=x.dtype, device=dev),
        torch.empty((ng, R, K, ret, dh), dtype=x.dtype, device=dev),
        torch.empty((ng, R, K, ret), dtype=torch.int32, device=dev),
        torch.empty((ng, R, K, ret), dtype=torch.bool, device=dev))

    def mamba_layers(x, layers):
        for l in layers:
            x, state[l], conv[l] = S.mamba_block_packed(
                T.layer_params(mamba, l), x, cfg, seg_ids[0], positions[0],
                cu_seqlens, block_start)
        return x

    for g, layers in enumerate(groups):
        x = mamba_layers(x, layers)
        x, packed, _ = T._layer_full_packed(
            shared, x, cfg, positions, seg_ids, token_valid, cos, sin, False,
            serve, cu_seqlens, *geom, mask_mode="causal")
        for dst, src in zip(kv, packed):
            dst[g] = src
    x = mamba_layers(x, tail)
    return x, HybridCache(ssm_state=state, conv=conv, kv=kv)


def forward_block_packed(params, cfg: ModelConfig, xb, block_positions,
                         cache: HybridCache, *, serve: T.ServeContext):
    """Token-packed hybrid Reuse. xb [R, Sb, D]; block_positions [R, Sb];
    cache: the gathered slot caches (batch axis R). The shared block runs
    one flat causal cross-attention dispatch over the ``[R·Sb]`` queries."""
    T._check_kernel_path(cfg, serve, xb.device)
    cos, sin = L.rope_tables(block_positions, cfg.resolved_head_dim,
                             cfg.rope_theta)
    R, Sb, _ = xb.shape
    Cr = cache.kv.k.shape[3]
    ar = torch.arange(R, dtype=torch.int32, device=xb.device)
    q_seg = ar.repeat_interleave(Sb)
    kv_seg = ar.repeat_interleave(Cr + Sb)
    mamba, shared = params["mamba"], params["shared"]
    groups, tail = _split_groups(cfg)

    def mamba_layers(xb, layers):
        for l in layers:
            xb = S.mamba_decode_block(T.layer_params(mamba, l), xb, cfg,
                                      cache.ssm_state[l], cache.conv[l])
        return xb

    kv = cache.kv
    for g, layers in enumerate(groups):
        xb = mamba_layers(xb, layers)
        xb = T._reuse_attention_layer_flat(
            shared, xb, cfg, cos, sin, block_positions, False, kv.k[g],
            kv.v[g], kv.pos[g], kv.valid[g], q_seg, kv_seg,
            mask_mode="causal")
        h2 = L.rms_norm(xb, shared["mlp_norm"], cfg.rms_eps)
        y, _ = T._mlp(shared, h2, cfg)
        xb = xb + y
    return mamba_layers(xb, tail)
