"""Embedding + output head with Logit-Aware Activation Budgeting (paper C1).

The packed decode of ``repro.models.lm_head``: the logit stage decodes the
iteration's hidden rows in serial ``max_num_logits`` sub-batches, either

  * ``fused``   — the fused logit-argmax kernel: the ``[chunk, V]`` logits
                  never exist in device memory (the main path), or
  * ``chunked`` — paper-faithful sub-batches materialising ``[chunk, V]``
                  float32 logits (plain PyTorch: CPU only in the port).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), params["table"])


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h [..., D] -> [..., V] float32 (final softcap applied)."""
    if cfg.tie_embeddings:
        z = h @ params["table"].t()
    else:
        z = h @ params["lm_head"]
    z = z.float()
    if cfg.final_softcap:
        z = cfg.final_softcap * torch.tanh(z / cfg.final_softcap)
    return z


def _decode_chunk_jnp(params, cfg: ModelConfig,
                      h_chunk) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's plain chunk decode: argmax and its softmax
    probability."""
    z = _logits(params, cfg, h_chunk)
    ids = z.argmax(dim=-1).to(torch.int32)
    conf = torch.exp(z.amax(dim=-1) - torch.logsumexp(z, dim=-1))
    return ids, conf


def decode_tokens_packed(params, cfg: ModelConfig, h: torch.Tensor,
                         valid: torch.Tensor, *, max_num_logits: int,
                         mode: str = "chunked"):
    """ArgMax decode over the whole-iteration packed hidden stream.

    h [N_exec, D] token-bucketed rows; valid [N_exec] bool. C1 chunking as
    in the reference; all-padding chunks are never computed, and invalid
    rows return (id 0, conf 0.0). Returns ([N_exec], [N_exec])."""
    if mode not in ("fused", "chunked"):
        raise NotImplementedError(
            f"logit_mode={mode!r} is not ported yet (ROADMAP Queue A, 'the "
            f"padded oracle path and the baseline systems')")
    N = h.shape[0]
    chunk = min(max_num_logits, N)
    if cfg.tie_embeddings:
        w, layout = params["table"], "vd"      # [V, D], no transpose
    else:
        w, layout = params["lm_head"], "dv"    # [D, V]
    ids = torch.zeros((N,), dtype=torch.int32, device=h.device)
    conf = torch.zeros((N,), dtype=torch.float32, device=h.device)
    for c0 in range(0, N, chunk):
        hb, vb = h[c0: c0 + chunk], valid[c0: c0 + chunk]
        if mode == "fused":
            i, c = ops.fused_logit_argmax(hb, w, softcap=cfg.final_softcap,
                                          w_layout=layout, valid=vb)
        else:
            # the chunked path branches around all-padding chunks with a
            # host check, which the fused kernel does in-kernel instead
            if not bool(vb.any()):
                continue
            i, c = _decode_chunk_jnp(params, cfg, hb)
            i = torch.where(vb, i, torch.zeros_like(i))
            c = torch.where(vb, c, torch.zeros_like(c))
        ids[c0: c0 + chunk] = i
        conf[c0: c0 + chunk] = c
    return ids, conf
