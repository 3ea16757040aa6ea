"""Embedding + output head with Logit-Aware Activation Budgeting (paper C1).

The decode of ``repro.models.lm_head`` (padded :func:`decode_tokens`,
packed :func:`decode_tokens_packed`): the logit stage decodes the
iteration's hidden rows

  * ``fused``      — in serial ``max_num_logits`` sub-batches of the fused
                     logit-argmax kernel: the ``[chunk, V]`` logits never
                     exist in device memory (the path on the card),
  * ``chunked``    — in paper-faithful sub-batches materialising
                     ``[chunk, V]`` float32 logits, or
  * ``monolithic`` — in one ``[N, V]`` float32 matrix (the baselines'
                     un-budgeted logit stage).

The last two are the reference's plain jnp path (no Pallas kernel), here
as torch ops, on the card as on the CPU. None of the three reads the
device from the host, so each can be captured in a stage's CUDA graph.
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


def logits_monolithic(params, cfg: ModelConfig,
                      h: torch.Tensor) -> torch.Tensor:
    """The un-budgeted baseline: the full [N, V] float32 logits."""
    return _logits(params, cfg, h)


def _decode_chunk_jnp(params, cfg: ModelConfig,
                      h_chunk) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's plain chunk decode: argmax and its softmax
    probability."""
    z = _logits(params, cfg, h_chunk)
    ids = z.argmax(dim=-1).to(torch.int32)
    conf = torch.exp(z.amax(dim=-1) - torch.logsumexp(z, dim=-1))
    return ids, conf


def _head(params, cfg: ModelConfig):
    """The output head weight and its layout for the fused kernel."""
    if cfg.tie_embeddings:
        return params["table"], "vd"      # [V, D], no transpose
    return params["lm_head"], "dv"        # [D, V]


def decode_tokens(params, cfg: ModelConfig, h: torch.Tensor, *,
                  max_num_logits: int, mode: str = "chunked"):
    """ArgMax decode and confidence of h [N, D] under the C1 budget: one
    pass when ``monolithic`` (or N fits the budget outside ``fused``),
    else serial ``max_num_logits`` chunks. Returns ([N] int32, [N] f32)."""
    N = h.shape[0]
    if mode == "monolithic" or N <= max_num_logits and mode != "fused":
        return _decode_chunk_jnp(params, cfg, h)
    if mode not in ("fused", "chunked"):
        raise ValueError(f"unknown logit mode {mode!r}")
    chunk = min(max_num_logits, N)
    w, layout = _head(params, cfg)
    ids, conf = [], []
    for c0 in range(0, N, chunk):
        hb = h[c0: c0 + chunk]
        if mode == "fused":
            i, c = ops.fused_logit_argmax(hb, w, softcap=cfg.final_softcap,
                                          w_layout=layout)
        else:
            i, c = _decode_chunk_jnp(params, cfg, hb)
        ids.append(i)
        conf.append(c)
    return torch.cat(ids), torch.cat(conf)


def decode_tokens_packed(params, cfg: ModelConfig, h: torch.Tensor,
                         valid: torch.Tensor, *, max_num_logits: int,
                         mode: str = "chunked"):
    """ArgMax decode over the whole-iteration packed hidden stream.

    h [N_exec, D] token-bucketed rows; valid [N_exec] bool. C1 chunking as
    in the reference; invalid rows return (id 0, conf 0.0). The fused kernel
    skips an all-padding chunk in-kernel; the chunked path computes it and
    masks it to zeros on the device, the same ids and confidences as the
    reference's ``lax.cond`` around it, with no host read. ``monolithic`` decodes every row in one
    pass. Returns ([N_exec], [N_exec])."""
    if mode == "monolithic":
        ids, conf = _decode_chunk_jnp(params, cfg, h)
        return (torch.where(valid, ids, torch.zeros_like(ids)),
                torch.where(valid, conf, torch.zeros_like(conf)))
    if mode not in ("fused", "chunked"):
        raise ValueError(f"unknown logit mode {mode!r}")
    N = h.shape[0]
    chunk = min(max_num_logits, N)
    w, layout = _head(params, cfg)
    ids = torch.zeros((N,), dtype=torch.int32, device=h.device)
    conf = torch.zeros((N,), dtype=torch.float32, device=h.device)
    for c0 in range(0, N, chunk):
        hb, vb = h[c0: c0 + chunk], valid[c0: c0 + chunk]
        if mode == "fused":
            i, c = ops.fused_logit_argmax(hb, w, softcap=cfg.final_softcap,
                                          w_layout=layout, valid=vb)
        else:
            i, c = _decode_chunk_jnp(params, cfg, hb)
            i = torch.where(vb, i, torch.zeros_like(i))
            c = torch.where(vb, c, torch.zeros_like(c))
        ids[c0: c0 + chunk] = i
        conf[c0: c0 + chunk] = c
    return ids, conf
