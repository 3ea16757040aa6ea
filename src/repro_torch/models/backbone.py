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

Families: dense, moe, ssm (mamba2), hybrid (zamba2), and the modality
frontends vlm (internvl2-76b) and audio (musicgen-medium), on both paths.
A frontend arch's request carries precomputed patch or frame embeddings
``[frontend_len, frontend_dim]`` (the vision or audio tower is a stub that
runs offline), projected by ``frontend.proj`` onto the first
``frontend_len`` rows of its sequence: the padded Refresh embeds a
``[B, F + S]`` batch, the packed Refresh a ``[F ; text]`` segment per
request (:func:`embed_inputs_packed`). The Reuse stream is text only: its
blocks see the prefix through the rows Refresh retained.
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


def mask_mode(cfg: ModelConfig) -> str:
    """Diffusion LMs are bidirectional; SSM-bearing archs are causal."""
    return "causal" if cfg.family in ("ssm", "hybrid") else "bidirectional"


def _project_frontend(params, cfg: ModelConfig, frontend, dtype):
    """[..., F, frontend_dim] embeddings -> [..., F, D] model rows."""
    if frontend is None:
        raise ValueError(f"{cfg.name} needs its frontend embeddings "
                         f"[frontend_len, frontend_dim] for each request")
    return frontend.to(dtype) @ params["frontend"]["proj"]


def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 frontend=None) -> torch.Tensor:
    """tokens [B, S] (and frontend [B, F, frontend_dim] for a frontend
    arch) -> [B, S, D], or [B, F + S, D] with the projected prefix rows
    first."""
    x = LM.embed_tokens(params["embed"], tokens)
    if cfg.frontend_dim:
        x = torch.cat([_project_frontend(params, cfg, frontend, x.dtype), x],
                      dim=1)
    return x


def embed_inputs_packed(params, cfg: ModelConfig, flat_tokens: torch.Tensor,
                        cu_seqlens=None, seq_lens=None,
                        frontend=None) -> torch.Tensor:
    """The packed stream's counterpart of :func:`embed_inputs`: [T] token
    stream -> [T, D]. For a frontend arch each request's segment is
    ``[frontend prefix ; text]``: the projected frontend [R, F, D] lands on
    rows ``cu_seqlens[r] + [0, F)`` over the placeholder tokens' rows.
    Padding requests (``seq_lens == 0``), and rows past the stream (a
    warmup's dummy segment in a bucket shorter than the prefix), write
    into a row after the stream, which is cut off, as the reference's
    ``mode="drop"`` drops them: a bucket-exact stream's real tail is never
    overwritten. No host read, so the stage can be captured."""
    x = LM.embed_tokens(params["embed"], flat_tokens)
    if not cfg.frontend_dim:
        return x
    T_len, D = x.shape
    F = cfg.frontend_len
    fe = _project_frontend(params, cfg, frontend, x.dtype)     # [R, F, D]
    rows = cu_seqlens[:, None].long() + torch.arange(F, device=x.device)
    rows = torch.where((seq_lens > 0)[:, None] & (rows < T_len), rows, T_len)
    buf = torch.cat([x, x.new_zeros((1, D))])
    buf.index_copy_(0, rows.reshape(-1), fe.reshape(-1, D))
    return buf[:T_len]


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
                  serve: T.ServeContext, token_valid=None,
                  frontend=None) -> RefreshOut:
    """Padded Refresh: the full forward of a ``[B, S]`` batch, capturing
    each row's serving cache (packed sparse KV, SSM state and conv history,
    or both), and the active blocks' final-normed hidden rows. tokens
    [B, S]; block_start [B], in the full sequence's coordinates (the
    frontend prefix first); token_valid [B, F + S]; frontend
    [B, F, frontend_dim] for a frontend arch."""
    x = embed_inputs(params, cfg, tokens, frontend)
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
                         block_start, serve: T.ServeContext,
                         frontend=None) -> RefreshOut:
    """Token-packed Refresh (§4.1 flattened engine): one flat ``[T]`` stream
    replaces the padded ``[B, S]`` batch, so compute scales with real
    tokens. Attention families run the segment-masked varlen attention
    stream; ssm/hybrid families the segment-reset SSD scan (the hybrid's
    shared block runs causal varlen attention). All stream arguments are
    ``[T]``; cu_seqlens/seq_lens/block_start are ``[R]``. A frontend arch's
    segments are ``[F ; text]`` (frontend [R, F, frontend_dim]), and
    seq_lens, positions and block_start count the prefix: a segment may be
    ``frontend_len`` longer than the text cap, so the per-request bound
    ``serve.max_seq_len`` widens by it."""
    if cfg.frontend_dim:
        serve = dataclasses.replace(
            serve, max_seq_len=serve.max_seq_len + cfg.frontend_len)
    x = embed_inputs_packed(params, cfg, flat_tokens, cu_seqlens, seq_lens,
                            frontend)[None]                   # [1, T, D]
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
    logit stage consumes. A frontend arch's blocks are text; their
    positions count the prefix."""
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
