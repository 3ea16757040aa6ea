"""Top-k routed Mixture-of-Experts FFN: the ``gather`` strategy of
``repro.models.moe`` (capacity-slot dispatch on one device).

Tokens are routed softmax-then-top-k with renormalised gates and the
Switch/GShard load-balance auxiliary loss. Each expert takes at most
``C = _capacity(T)`` tokens, ``T`` being the rows of the call: the bucketed
stream a stage runs (packed Refresh ``tp``, packed Reuse ``R·Sb``, padded
``B·S``), padding rows included, so a request's routing depends on its
bucket exactly as in the reference. Assignments past an expert's capacity
drop. The experts run as one batched product over ``[E, C, D]`` slots, and
a combine gather weights their outputs back to the tokens.

Every shape is fixed by ``T`` and the config, and the dispatch uses no
``nonzero``, boolean-mask indexing or host read, so a stage holding it
captures as one CUDA graph. The reference's expert-parallel strategy
(``moe_impl="ep"``) needs a device mesh and raises here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def _route(p, x2d, cfg: ModelConfig):
    """Router: (gates [T, k] in x2d's dtype, expert_idx [T, k], aux_loss).
    The top k come from a stable descending sort, so of tied probabilities
    the lower expert index wins, as in ``jax.lax.top_k``."""
    logits = (x2d @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = order.values[:, :k], order.indices[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux: E * sum_e f_e * p_e, f_e the top-1 fraction
    E = cfg.n_experts
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gates.to(x2d.dtype), idx, aux


def _capacity(T: int, cfg: ModelConfig) -> int:
    """Slots an expert takes for a call of ``T`` rows: ``T·k·cf / E``,
    rounded up to a multiple of 8, at least 8."""
    c = int(T * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _dispatch_indices(idx, T: int, E: int, C: int):
    """Capacity-slot assignment, first come first served in (token, k)
    order. Returns (slot [T, k], keep [T, k], inv [E·C]: the token in each
    slot, -1 where empty). A dropped assignment's slot is the drop bin
    ``E·C``, which is cut from ``inv``: its duplicate writes land there."""
    k = idx.shape[1]
    flat = idx.reshape(-1)                                  # [T·k]
    counts = torch.cumsum(F.one_hot(flat, E), dim=0)        # [T·k, E]
    pos = counts.gather(1, flat[:, None])[:, 0] - 1         # within expert
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, E * C)
    token_of = torch.arange(T, device=idx.device).repeat_interleave(k)
    inv = torch.full((E * C + 1,), -1, dtype=torch.long, device=idx.device)
    inv[slot] = token_of
    return slot.reshape(T, k), keep.reshape(T, k), inv[:-1]


def _expert_ffn(p, x_disp, cfg: ModelConfig):
    """x_disp [E, C, D] -> [E, C, D], each expert's gated MLP (``gelu`` is
    the tanh form, what ``jax.nn.gelu`` computes by default)."""
    gate = torch.bmm(x_disp, p["w_gate"])
    g = (F.gelu(gate, approximate="tanh") if cfg.activation == "gelu"
         else F.silu(gate))
    return torch.bmm(g * torch.bmm(x_disp, p["w_up"]), p["w_down"])


def _moe_gather(p, x2d, cfg: ModelConfig):
    """Capacity-slot dispatch, experts, combine. x2d [T, D] -> ([T, D],
    aux)."""
    T, D = x2d.shape
    E = cfg.n_experts
    C = _capacity(T, cfg)
    gates, idx, aux = _route(p, x2d, cfg)
    slot, keep, inv = _dispatch_indices(idx, T, E, C)
    x_disp = torch.where((inv >= 0)[:, None], x2d[inv.clamp_min(0)], 0)
    y = _expert_ffn(p, x_disp.reshape(E, C, D), cfg).reshape(E * C, D)
    y = torch.cat([y, y.new_zeros((1, D))])                 # the drop bin
    y_tok = y[torch.where(keep, slot, E * C)]               # [T, k, D]
    out = torch.einsum("tkd,tk->td", y_tok, gates * keep)
    return out, aux


def moe_ffn(p, x, cfg: ModelConfig):
    """x [..., D] -> (out [..., D], aux_loss); the routing and capacity run
    over all of x's rows at once."""
    if cfg.moe_impl == "ep":
        raise NotImplementedError(
            "moe_impl='ep' (expert parallelism over a device mesh) is not "
            "ported yet (ROADMAP Queue A, 'multi-GPU')")
    D = x.shape[-1]
    out, aux = _moe_gather(p, x.reshape(-1, D), cfg)
    return out.reshape(x.shape), aux
