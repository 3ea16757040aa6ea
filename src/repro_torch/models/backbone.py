"""Model API the engine calls: parameters and the serving stages.

  * :func:`init_params` — random weights for an arch, drawn on the device.
  * :func:`serve_refresh` / :func:`serve_reuse` — the padded stages: a
    ``[B, S]`` batch per Refresh, a ``[B, Sb]`` block batch per Reuse (the
    oracle, and the path of the three baseline systems).
  * :func:`serve_refresh_packed` — the paper's **Refresh** phase over one
    token-packed stream: capture each request's serving cache (packed sparse
    KV, SSM state and conv history, or both) and return its active block's
    final-normed hidden rows.
  * :func:`serve_reuse_packed` — the **Reuse** phase: the active blocks as
    one packed stream against their gathered slot caches.

Families: dense, moe, ssm (mamba2) and hybrid (zamba2), on both paths;
the modality frontends come with a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import lm_head as LM
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.params import init_params  # noqa: F401  (the model API)

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.frontend_dim:
        raise NotImplementedError(
            "modality frontends are not ported yet (ROADMAP Queue A, "
            "'frontends')")


def mask_mode(cfg: ModelConfig) -> str:
    """Diffusion LMs are bidirectional; SSM-bearing archs are causal."""
    return "causal" if cfg.family in ("ssm", "hybrid") else "bidirectional"


def embed_inputs(params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] tokens -> [B, S, D] (text-only archs)."""
    _check_family(cfg)
    return LM.embed_tokens(params["embed"], tokens)


def embed_inputs_packed(params, cfg: ModelConfig,
                        flat_tokens: torch.Tensor) -> torch.Tensor:
    """[T] token stream -> [T, D] (text-only archs)."""
    _check_family(cfg)
    return LM.embed_tokens(params["embed"], flat_tokens)


def _final(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(h, params["final_norm"], cfg.rms_eps)


def _serve_chunk_cfg(cfg: ModelConfig, block_size: int) -> ModelConfig:
    """The SSM chunk must divide block boundaries for state capture."""
    if cfg.family in ("ssm", "hybrid"):
        c = math.gcd(cfg.ssm_chunk, block_size)
        if c != cfg.ssm_chunk:
            return dataclasses.replace(cfg, ssm_chunk=c)
    return cfg


class RefreshOut(NamedTuple):
    block_hidden: torch.Tensor   # [R, Sb, D] (final-normed)
    cache: object                # PackedKV | SSMCache | HybridCache


def serve_refresh(params, cfg: ModelConfig, tokens, block_start,
                  serve: T.ServeContext, token_valid=None) -> RefreshOut:
    """Padded Refresh: the full forward of a ``[B, S]`` batch, capturing
    each row's serving cache (packed sparse KV, SSM state and conv history,
    or both), and the active blocks' final-normed hidden rows. tokens
    [B, S]; block_start [B]; token_valid [B, S]."""
    x = embed_inputs(params, cfg, tokens)
    B, S_len, _ = x.shape
    positions = torch.arange(S_len, dtype=torch.int32,
                             device=x.device).expand(B, S_len)
    if token_valid is None:
        token_valid = torch.ones((B, S_len), dtype=torch.bool,
                                 device=x.device)
    if cfg.family in ATTN_FAMILIES:
        h, cache, _ = T.forward_full(
            params["stack"], cfg, x, positions, token_valid=token_valid,
            mask_mode=mask_mode(cfg), serve=serve, block_start=block_start)
    elif cfg.family == "ssm":
        ccfg = _serve_chunk_cfg(cfg, serve.block_size)
        h, states, convs = x, [], []
        for l in range(cfg.n_layers):
            h, st, hi = S.mamba_block(T.layer_params(params["stack"], l), h,
                                      ccfg, capture_at=block_start)
            states.append(st)
            convs.append(hi)
        cache = S.SSMCache(state=torch.stack(states),
                           conv=torch.stack(convs))
    else:
        h, cache = HY.forward_full(
            params["stack"], _serve_chunk_cfg(cfg, serve.block_size), x,
            positions, token_valid=token_valid, serve=serve,
            block_start=block_start)
    bh = T.slice_block(_final(params, cfg, h), block_start,
                       serve.block_size)
    return RefreshOut(block_hidden=bh, cache=cache)


def serve_reuse(params, cfg: ModelConfig, block_tokens, block_positions,
                cache, serve: T.ServeContext) -> torch.Tensor:
    """Padded Reuse: block_tokens/block_positions [B, Sb] against the
    gathered caches (batch axis B). Returns final-normed [B, Sb, D]."""
    xb = LM.embed_tokens(params["embed"], block_tokens)
    if cfg.family in ATTN_FAMILIES:
        h = T.forward_block(params["stack"], cfg, xb, block_positions,
                            cache, serve=serve, mask_mode=mask_mode(cfg))
    elif cfg.family == "ssm":
        h = _ssm_reuse(params, cfg, xb, cache)
    else:
        h = HY.forward_block(params["stack"], cfg, xb, block_positions,
                             cache, serve=serve)
    return _final(params, cfg, h)


def _ssm_refresh(stack, cfg: ModelConfig, x, seg_ids, positions, cu_seqlens,
                 block_start, use_kernel: bool):
    """The Mamba2 stack over a packed stream -> (hidden, SSMCache); the
    scan in its kernel under ``use_kernel``, else in the plain fallback."""
    R = cu_seqlens.shape[0]
    state = torch.empty((cfg.n_layers, R, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=x.device)
    conv = torch.empty((cfg.n_layers, R, cfg.ssm_conv_kernel - 1,
                        S.conv_channels(cfg)), dtype=x.dtype, device=x.device)
    for l in range(cfg.n_layers):
        x, state[l], conv[l] = S.mamba_block_packed(
            T.layer_params(stack, l), x, cfg, seg_ids, positions, cu_seqlens,
            block_start, use_kernel=use_kernel)
    return x, S.SSMCache(state=state, conv=conv)


def serve_refresh_packed(params, cfg: ModelConfig, flat_tokens, positions,
                         seg_ids, token_valid, cu_seqlens, seq_lens,
                         block_start, serve: T.ServeContext) -> RefreshOut:
    """Token-packed Refresh (§4.1 flattened engine): one flat ``[T]`` stream
    replaces the padded ``[B, S]`` batch, so compute scales with real
    tokens. Attention families run the segment-masked varlen attention
    stream; ssm/hybrid families the segment-reset SSD scan (the hybrid's
    shared block runs causal varlen attention). All stream arguments are
    ``[T]``; cu_seqlens/seq_lens/block_start are ``[R]``."""
    x = embed_inputs_packed(params, cfg, flat_tokens)[None]   # [1, T, D]
    if cfg.family in ATTN_FAMILIES:
        h, cache, _ = T.forward_full_packed(
            params["stack"], cfg, x, positions[None], seg_ids[None],
            token_valid[None], cu_seqlens, seq_lens, block_start, serve)
    elif cfg.family == "ssm":
        T._check_kernel_path(serve, x.device)
        h, cache = _ssm_refresh(
            params["stack"], _serve_chunk_cfg(cfg, serve.block_size), x,
            seg_ids, positions, cu_seqlens, block_start,
            bool(serve.use_flash_refresh or serve.use_flash_kernel))
    else:
        h, cache = HY.forward_full_packed(
            params["stack"], _serve_chunk_cfg(cfg, serve.block_size), x,
            positions[None], seg_ids[None], token_valid[None], cu_seqlens,
            seq_lens, block_start, serve)
    hn = _final(params, cfg, h)[0]                            # [T, D]
    rows = T.packed_block_rows(cu_seqlens, block_start, serve.block_size,
                               hn.shape[0])
    return RefreshOut(block_hidden=hn[rows.long()], cache=cache)


def _ssm_reuse(params, cfg: ModelConfig, xb, cache: S.SSMCache):
    """Reuse-phase Mamba2 decode over the layer stack."""
    for l in range(cfg.n_layers):
        xb = S.mamba_decode_block(T.layer_params(params["stack"], l), xb, cfg,
                                  cache.state[l], cache.conv[l])
    return xb


def serve_reuse_packed(params, cfg: ModelConfig, flat_tokens, flat_positions,
                       cache, serve: T.ServeContext) -> torch.Tensor:
    """Token-packed Reuse: the R active blocks as one ``[R·Sb]`` query
    stream against their gathered slot caches (SSM blocks decode
    recurrently from their cached states; hybrids add the causal shared
    block). Returns the flat ``[Tq, D]`` final-normed hidden stream the
    logit stage consumes."""
    _check_family(cfg)
    Sb = serve.block_size
    Tq = flat_tokens.shape[0]
    R = Tq // Sb
    xb = LM.embed_tokens(params["embed"], flat_tokens.reshape(R, Sb))
    if cfg.family in ATTN_FAMILIES:
        h = T.forward_block_packed(params["stack"], cfg, xb,
                                   flat_positions.reshape(R, Sb), cache,
                                   serve=serve)
    elif cfg.family == "ssm":
        T._check_kernel_path(serve, xb.device)
        h = _ssm_reuse(params, cfg, xb, cache)
    else:
        h = HY.forward_block_packed(params["stack"], cfg, xb,
                                    flat_positions.reshape(R, Sb), cache,
                                    serve=serve)
    return _final(params, cfg, h).reshape(Tq, -1)
