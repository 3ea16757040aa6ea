"""AdamW from scratch, with global-norm clipping, a cosine schedule with
warmup and gradient compression: ``repro.train.optimizer`` in float32.

Gradients travel as lists aligned with ``params.named_leaves`` (the
reference's flatten order); the moments are dicts keyed by leaf name.

Gradient compression (``TrainConfig.grad_compression``):
  * ``bf16`` — gradients are cast to bf16 at the microbatch boundary (and
    accumulated in bf16), which halves what a cross-replica reduce moves.
  * ``int8`` — per-tensor symmetric quantize→dequantize of each gradient.

``zero1`` shards the moments over a data axis in the reference; on one
device there is nothing to shard, so it has no effect here either.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.params import named_leaves


def init_opt_state(params) -> dict:
    """Float32 zero moments for every leaf, and the step (int32)."""
    leaves = named_leaves(params)
    zeros = lambda: {n: torch.zeros(t.shape, dtype=torch.float32,
                                    device=t.device) for n, t in leaves}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0][1].device)}


def lr_schedule(step: torch.Tensor, tc: TrainConfig,
                total_steps: int = 10_000) -> torch.Tensor:
    s = step.float()
    warm = torch.clamp(s / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - tc.warmup_steps)
                       / max(total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tensors])))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return [g.float() * scale for g in grads], gn


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-9) / 127.0
    return (torch.round(g32 / scale).to(torch.int8).float()
            * scale).to(g.dtype)


def compress_grads(grads: Sequence[torch.Tensor],
                   mode: str) -> List[torch.Tensor]:
    if mode == "bf16":
        return [g.to(torch.bfloat16) for g in grads]
    if mode == "int8":
        return [_int8_roundtrip(g) for g in grads]
    return list(grads)


@torch.no_grad()
def adamw_update(params, grads: Sequence[torch.Tensor], opt: dict,
                 tc: TrainConfig, total_steps: int = 10_000):
    """One AdamW step, clipped to ``tc.grad_clip``, applied in place to the
    parameters and the moments one tensor at a time (a tensor's float32
    temporaries are freed before the next; a foreach over every tensor
    would hold several float32 copies of the largest ones at once). The
    arithmetic is the reference's: bias corrections from the float step,
    ``weight_decay·p`` inside the update, the result cast to the
    parameter's dtype. Returns (params, opt, {grad_norm, lr})."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, tc.grad_clip)
    step = opt["step"] + 1
    lr = lr_schedule(step, tc, total_steps)
    b1, b2 = tc.beta1, tc.beta2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    for (name, p), g in zip(named_leaves(params), grads):
        m, v = opt["m"][name], opt["v"][name]
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        delta = (m / c1).div_((v / c2).sqrt_().add_(tc.eps))
        p32 = p.float()
        delta.add_(tc.weight_decay * p32)
        p.copy_(p32.sub_(delta.mul_(lr)))
    opt["step"] = step
    return params, opt, {"grad_norm": gn, "lr": lr}
