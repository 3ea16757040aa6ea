"""Zamba2-style hybrid backbone, the serving paths of
``repro.models.hybrid``: a Mamba2 stack and one *shared* attention block.

``n_layers`` Mamba2 layers form groups of ``shared_attn_interval``; after
each group the single weight-tied attention+MLP block runs, causal. The
remaining layers form a tail. The reference's ``lax.scan`` over groups is
index arithmetic over the stacked ``[L]`` axis here.

Serving caches: per Mamba layer the recurrent state and conv history at
``block_start``; per shared-block invocation the head-centric packed KV.
The padded :func:`forward_full` / :func:`forward_block` (the oracle, and
the baselines' path) and the packed :func:`forward_full_packed` /
:func:`forward_block_packed` emit and read the same :class:`HybridCache`;
both Reuse paths walk the groups and the tail in :func:`_block_scan`.
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


def forward_full(params, cfg: ModelConfig, x, positions, *,
                 token_valid=None, serve=None, block_start=None,
                 remat: bool = False):
    """Padded hybrid Refresh, and the training forward: the Mamba2 groups,
    each followed by the shared block's causal ``_layer_full``, then the
    tail. x [B, S, D]; positions/token_valid [B, S]; block_start [B]. With
    ``serve`` every layer captures its serving cache at ``block_start``.
    ``remat`` (training) recomputes in backward at the reference's two
    levels: each Mamba layer, and each group with its shared block.
    Returns (hidden [B, S, D], :class:`HybridCache` or None)."""
    B, S_len, _ = x.shape
    if token_valid is None:
        token_valid = torch.ones((B, S_len), dtype=torch.bool,
                                 device=x.device)
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    capture = block_start if serve is not None else None
    mamba, shared = params["mamba"], params["shared"]
    groups, tail = _split_groups(cfg)
    states, convs, packs = [], [], []

    mamba_p = T.layer_slices(mamba)

    def mamba_layers(x, layers):
        for l in layers:
            if capture is None:
                x = (L.remat(S.mamba_block, mamba_p[l], x, cfg) if remat
                     else S.mamba_block(mamba_p[l], x, cfg))
                continue
            x, st, hi = S.mamba_block(mamba_p[l], x, cfg, capture_at=capture)
            states.append(st)
            convs.append(hi)
        return x

    def group(x, layers):
        x = mamba_layers(x, layers)
        return T._layer_full(shared, x, cfg, positions, cos, sin, False,
                             token_valid, "causal", serve, capture)

    for layers in groups:
        x, packed, _ = (L.remat(group, x, layers) if remat
                        else group(x, layers))
        packs.append(packed)
    x = mamba_layers(x, tail)
    if serve is None:
        return x, None
    kv = PackedKV(*[torch.stack(f) for f in zip(*packs)])
    return x, HybridCache(ssm_state=torch.stack(states),
                          conv=torch.stack(convs), kv=kv)


def forward_full_packed(params, cfg: ModelConfig, x, positions, seg_ids,
                        token_valid, cu_seqlens, seq_lens, block_start,
                        serve: T.ServeContext):
    """Token-packed hybrid Refresh: the Mamba2 layers run the segment-reset
    scan with per-request capture, the shared block the causal varlen
    attention with in-place select/pack. x [1, T, D]; positions/seg_ids/
    token_valid [1, T]; cu_seqlens/seq_lens/block_start [R]. Returns
    (hidden [1, T, D], :class:`HybridCache`)."""
    assert serve.max_seq_len > 0, "packed path needs ServeContext.max_seq_len"
    T._check_kernel_path(serve, x.device)
    T_len = x.shape[1]
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    geom = T.packed_refresh_geometry(cu_seqlens, seq_lens, block_start, T_len,
                                     serve)
    mamba, shared = params["mamba"], params["shared"]
    groups, tail = _split_groups(cfg)
    R, dev = cu_seqlens.shape[0], x.device
    K, dh, ret = T.kv_heads(shared), cfg.resolved_head_dim, serve.retain
    state = torch.empty((cfg.n_layers, R, S.local_heads(mamba, cfg),
                         cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=dev)
    conv = torch.empty((cfg.n_layers, R, cfg.ssm_conv_kernel - 1,
                        S.conv_channels(cfg)), dtype=x.dtype, device=dev)
    ng = len(groups)
    kv = PackedKV(
        torch.empty((ng, R, K, ret, dh), dtype=x.dtype, device=dev),
        torch.empty((ng, R, K, ret, dh), dtype=x.dtype, device=dev),
        torch.empty((ng, R, K, ret), dtype=torch.int32, device=dev),
        torch.empty((ng, R, K, ret), dtype=torch.bool, device=dev))

    use_k = bool(serve.use_flash_refresh or serve.use_flash_kernel)

    def mamba_layers(x, layers):
        for l in layers:
            x, state[l], conv[l] = S.mamba_block_packed(
                T.layer_params(mamba, l), x, cfg, seg_ids[0], positions[0],
                cu_seqlens, block_start, use_kernel=use_k)
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


def _block_scan(params, cfg: ModelConfig, xb, cache: HybridCache, attn):
    """The Reuse walk shared by the padded and packed paths: each group's
    Mamba2 decode, then the shared block with the attention sublayer
    ``attn(h, ck, cv, cpos, cvalid)`` injected and its MLP, then the tail,
    so the two paths cannot drift."""
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
        xb = attn(xb, kv.k[g], kv.v[g], kv.pos[g], kv.valid[g])
        h2 = L.rms_norm(xb, shared["mlp_norm"], cfg.rms_eps)
        y, _ = T._mlp(shared, h2, cfg)
        xb = xb + y
    return mamba_layers(xb, tail)


def forward_block(params, cfg: ModelConfig, xb, block_positions,
                  cache: HybridCache, *, serve: T.ServeContext):
    """Padded hybrid Reuse. xb [B, Sb, D]; block_positions [B, Sb]; cache:
    the gathered slot caches (batch axis B). The shared block's causal
    attention is the split Reuse attention (``packed_flash_attention`` on
    the cache half under ``use_flash_kernel``)."""
    T._check_kernel_path(serve, xb.device)
    cos, sin = L.rope_tables(block_positions, cfg.resolved_head_dim,
                             cfg.rope_theta)

    def attn(h, ck, cv, cpos, cval):
        return T.reuse_attention_layer(
            params["shared"], h, cfg, cos, sin, block_positions, False, ck,
            cv, cpos, cval, "causal", use_kernel=serve.use_flash_kernel,
            concat=serve.reuse_concat, kv_split=serve.kv_split)

    return _block_scan(params, cfg, xb, cache, attn)


def forward_block_packed(params, cfg: ModelConfig, xb, block_positions,
                         cache: HybridCache, *, serve: T.ServeContext):
    """Token-packed hybrid Reuse. xb [R, Sb, D]; block_positions [R, Sb];
    cache: the gathered slot caches (batch axis R). Under
    ``use_flash_kernel`` the shared block runs one flat causal
    cross-attention dispatch over the ``[R·Sb]`` queries; without it the
    split attention over the same R requests (CPU only)."""
    T._check_kernel_path(serve, xb.device)
    cos, sin = L.rope_tables(block_positions, cfg.resolved_head_dim,
                             cfg.rope_theta)
    R, Sb, _ = xb.shape
    Cr = cache.kv.k.shape[3]
    ar = torch.arange(R, dtype=torch.int32, device=xb.device)
    q_seg = ar.repeat_interleave(Sb)
    kv_seg = ar.repeat_interleave(Cr + Sb)
    shared = params["shared"]

    def attn(h, ck, cv, cpos, cval):
        # _check_kernel_path above refuses the plain branch on the card
        if serve.use_flash_kernel:  # lint: allow(silent-fallback)
            return T._reuse_attention_layer_flat(
                shared, h, cfg, cos, sin, block_positions, False, ck, cv,
                cpos, cval, q_seg, kv_seg, mask_mode="causal",
                kv_split=serve.kv_split)
        return T.reuse_attention_layer(
            shared, h, cfg, cos, sin, block_positions, False, ck, cv, cpos,
            cval, "causal", concat=serve.reuse_concat,
            kv_split=serve.kv_split)

    return _block_scan(params, cfg, xb, cache, attn)
