"""Masked-diffusion training loss (LLaDA objective) with C1 chunking, the
loss of ``repro.train.loss``.

For each sequence a mask ratio u ~ U(lo, hi) is drawn; tokens are masked
i.i.d. with probability u and the cross-entropy on masked positions is
weighted by 1/u — the discrete-diffusion ELBO estimator. The CE runs
through ``lm_head.diffusion_loss``: token-axis chunks of ``loss_chunk``, so
the ``[T, V]`` logit tensor never exists (the paper's C1 applied to
training).

:func:`loss_fn` is :func:`corrupt` followed by :func:`masked_loss`, the
loss over a given corruption: the draws come from a ``torch.Generator``,
which cannot repeat ``jax.random``'s, so the parity tests hand the
reference's corruption to :func:`masked_loss`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.diffusion import mask_token_id
from repro_torch.models import backbone as BB
from repro_torch.models import lm_head as LM

AUX_COEF = 0.01


def corrupt(tokens: torch.Tensor, generator: torch.Generator,
            cfg: ModelConfig, tc: TrainConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample per-sequence mask ratios and mask tokens. tokens [B, S].
    The draws are made on ``generator``'s device (the trainer's lives on
    the tokens' device; a CPU generator gives a card run the CPU's draws).
    Returns (corrupted [B, S], weights [B, S] float32: mask / u)."""
    B, S = tokens.shape
    lo, hi = tc.mask_ratio_min, tc.mask_ratio_max
    dev = generator.device
    u = torch.rand((B, 1), generator=generator, device=dev) * (hi - lo) + lo
    mask = torch.rand((B, S), generator=generator, device=dev) < u
    u, mask = u.to(tokens.device), mask.to(tokens.device)
    corrupted = tokens.masked_fill(mask, mask_token_id(cfg.vocab_size))
    return corrupted, mask.float() / u      # 1/t ELBO weighting


def masked_loss(params, cfg: ModelConfig, tc: TrainConfig,
                tokens: torch.Tensor, corrupted: torch.Tensor,
                weights: torch.Tensor, frontend: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
    """The loss of ``corrupted`` [B, S] against the clean ``tokens``,
    weighted by ``weights``; a frontend arch supervises its text region
    only. Returns (ce + AUX_COEF·aux, {ce, aux})."""
    h, aux = BB.train_forward(params, cfg, corrupted, frontend,
                              remat=tc.remat)
    if cfg.frontend_dim:
        h = h[:, cfg.frontend_len:]     # supervise the text region only
    ce = LM.diffusion_loss(params["embed"], cfg, h, tokens, weights,
                           chunk=tc.loss_chunk)
    loss = ce + AUX_COEF * aux
    return loss, {"ce": ce, "aux": aux}


def loss_fn(params, cfg: ModelConfig, tc: TrainConfig, tokens: torch.Tensor,
            generator: torch.Generator,
            frontend: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    corrupted, weights = corrupt(tokens, generator, cfg, tc)
    return masked_loss(params, cfg, tc, tokens, corrupted, weights, frontend)
