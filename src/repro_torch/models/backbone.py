"""Model API the engine calls: parameters and the packed serving stages.

  * :func:`init_params` — random weights for an arch, drawn on the device.
  * :func:`serve_refresh_packed` — the paper's **Refresh** phase over one
    token-packed stream: capture each request's packed sparse KV and return
    its active block's final-normed hidden rows.
  * :func:`serve_reuse_packed` — the **Reuse** phase: the active blocks as
    one packed stream against their gathered slot caches.

The attention families only: dense here (MoE raises in the layers);
SSM/hybrid and the modality frontends come with later slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm_head as LM
from repro_torch.models import transformer as T
from repro_torch.params import init_params  # noqa: F401  (the model API)

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ATTN_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A, "
            f"'scan families')")
    if cfg.frontend_dim:
        raise NotImplementedError(
            "modality frontends are not ported yet (ROADMAP Queue A, 'MoE "
            "and frontends')")


def embed_inputs_packed(params, cfg: ModelConfig,
                        flat_tokens: torch.Tensor) -> torch.Tensor:
    """[T] token stream -> [T, D] (text-only archs)."""
    _check_family(cfg)
    return LM.embed_tokens(params["embed"], flat_tokens)


def _final(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(h, params["final_norm"], cfg.rms_eps)


class RefreshOut(NamedTuple):
    block_hidden: torch.Tensor   # [R, Sb, D] (final-normed)
    cache: object                # PackedKV with a leading [L] axis


def serve_refresh_packed(params, cfg: ModelConfig, flat_tokens, positions,
                         seg_ids, token_valid, cu_seqlens, seq_lens,
                         block_start, serve: T.ServeContext) -> RefreshOut:
    """Token-packed Refresh (§4.1 flattened engine): one flat ``[T]`` stream
    replaces the padded ``[B, S]`` batch, so compute scales with real
    tokens. All stream arguments are ``[T]``; cu_seqlens/seq_lens/
    block_start are ``[R]``."""
    x = embed_inputs_packed(params, cfg, flat_tokens)[None]   # [1, T, D]
    h, cache, _ = T.forward_full_packed(
        params["stack"], cfg, x, positions[None], seg_ids[None],
        token_valid[None], cu_seqlens, seq_lens, block_start, serve)
    hn = _final(params, cfg, h)[0]                            # [T, D]
    rows = T.packed_block_rows(cu_seqlens, block_start, serve.block_size,
                               hn.shape[0])
    return RefreshOut(block_hidden=hn[rows.long()], cache=cache)


def serve_reuse_packed(params, cfg: ModelConfig, flat_tokens, flat_positions,
                       cache, serve: T.ServeContext) -> torch.Tensor:
    """Token-packed Reuse: the R active blocks as one ``[R·Sb]`` query
    stream against their gathered slot caches. Returns the flat
    ``[Tq, D]`` final-normed hidden stream the logit stage consumes."""
    _check_family(cfg)
    Sb = serve.block_size
    Tq = flat_tokens.shape[0]
    R = Tq // Sb
    xb = LM.embed_tokens(params["embed"], flat_tokens.reshape(R, Sb))
    h = T.forward_block_packed(params["stack"], cfg, xb,
                               flat_positions.reshape(R, Sb), cache,
                               serve=serve)
    return _final(params, cfg, h).reshape(Tq, -1)
