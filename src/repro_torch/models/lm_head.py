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

Vocab-parallel on a serving mesh, in all three modes: a rank holds ``V/m``
rows of the table (and columns of an untied head), decodes its local
``[N, V/m]`` logits to a local ``(index, max, sum)`` and merges them
across the model group (``kernels.ops.gather_vocab_shards``); the full
``[N, V]`` never gathers. The embedding looks up the rank's rows and sums
over the model axis.

The same decomposition bounds the training loss (:func:`diffusion_loss`):
the masked-diffusion cross-entropy runs over token-axis chunks whose
``[chunk, V]`` logits are recomputed in backward, so neither pass holds
the ``[T, V]`` tensor. Torch ops under autograd, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L


def embed_tokens(params, tokens: torch.Tensor,
                 vocab_size: int = 0) -> torch.Tensor:
    """Rows of the table for ``tokens``. A table of fewer than
    ``vocab_size`` rows is this rank's vocab shard: ids outside it look up
    zeros, and the model axis sums the ranks' rows (exact: one rank holds
    each id)."""
    table = params["table"]
    Vl = table.shape[0]
    if not vocab_size or Vl == vocab_size:
        return F.embedding(tokens.long(), table)
    local = tokens.long() - L.tp_index() * Vl
    mine = (local >= 0) & (local < Vl)
    x = F.embedding(local.clamp(0, Vl - 1), table)
    return L.tp_sum(x.masked_fill(~mine[..., None], 0))


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
    probability; over the rank's vocab shard, merged across the model
    axis, when the head is sharded."""
    z = _logits(params, cfg, h_chunk)
    if z.shape[-1] == cfg.vocab_size:
        ids = z.argmax(dim=-1).to(torch.int32)
        conf = torch.exp(z.amax(dim=-1) - torch.logsumexp(z, dim=-1))
        return ids, conf
    mx = z.amax(dim=-1)
    s = torch.exp(z - mx[:, None]).sum(dim=-1)
    ids, mx, s = ops.gather_vocab_shards(
        M.tp(), z.argmax(dim=-1).to(torch.int32), mx, s, z.shape[-1])
    return ids, torch.exp(mx - (mx + torch.log(s)))


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


def diffusion_loss(params, cfg: ModelConfig, h: torch.Tensor,
                   labels: torch.Tensor, weights: torch.Tensor, *,
                   chunk: int = 2048) -> torch.Tensor:
    """Masked-diffusion CE, token-axis chunked (C1 applied to training):
    ``sum(nll · w) / max(sum(w), 1)`` over h [B, S, D], labels [B, S] and
    weights [B, S] (float; 0 where unsupervised). The B·S rows are padded
    to a multiple of ``chunk`` and stride-chunked as in the reference
    (chunk b takes rows ``{a·nch + b}``); each chunk's ``[chunk, V]``
    float32 logits (softcapped where the config asks) are recomputed in
    backward, never kept. Returns a float32 scalar."""
    B, S, D = h.shape
    hf = h.reshape(B * S, D)
    lf = labels.reshape(-1)
    wf = weights.reshape(-1).float()
    N = B * S
    chunk = min(chunk, N)
    pad = (-N) % chunk
    if pad:
        hf = F.pad(hf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad))
        wf = F.pad(wf, (0, pad))
    nch = hf.shape[0] // chunk
    # chunk b is column b of the [chunk, nch] row grid: a strided view
    hc = hf.reshape(chunk, nch, D).transpose(0, 1)
    lc = lf.reshape(chunk, nch).t()
    wc = wf.reshape(chunk, nch).t()

    def body(hb, lb, wb):
        z = _logits(params, cfg, hb)                      # [chunk, V] f32
        gold = z.gather(1, lb[:, None].long())[:, 0]
        return ((torch.logsumexp(z, dim=-1) - gold) * wb).sum()

    tot = wf.new_zeros(())
    cnt = wf.new_zeros(())
    for b in range(nch):
        tot = tot + L.remat(body, hc[b], lc[b], wc[b])
        cnt = cnt + wc[b].sum()
    return tot / cnt.clamp_min(1.0)
