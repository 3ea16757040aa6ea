"""Top-k routed Mixture-of-Experts FFN: the two strategies of
``repro.models.moe``, ``gather`` (capacity-slot dispatch) and ``ep``
(expert parallelism over a serving mesh).

Tokens are routed softmax-then-top-k with renormalised gates and the
Switch/GShard load-balance auxiliary loss. Each expert takes at most
``C = _capacity(T)`` tokens, ``T`` being the rows of the call: the bucketed
stream a stage runs (packed Refresh ``tp``, packed Reuse ``R·Sb``, padded
``B·S``), padding rows included, so a request's routing depends on its
bucket exactly as in the reference. Assignments past an expert's capacity
drop. The experts run as one batched product over ``[E, C, D]`` slots, and
a combine gather weights their outputs back to the tokens.

``gather`` on a serving mesh runs on the reference's expert placement
(``launch.sharding.Rules``): ``w_gate`` / ``w_up`` ``[E, D, F]`` split by
expert over ``model`` and by ``d_model`` over ``data``, ``w_down``
``[E, F, D]`` split by the expert hidden ``F`` over ``model`` with every
expert on every rank, the router whole. The routing and the capacity stay
global (every rank routes every row with the whole router over all ``E``
experts), so ids and drops are the one-device call's. A rank then
contracts its ``D`` slice for its own experts and sums the pre-activations
over ``data``, gathers the hidden ``[E·C, F]`` over ``model`` and keeps its
``F/m`` columns, and sums the combined ``w_down`` partials over ``model``.
Off a mesh, or on a mesh that splits none of the stacks, it is the
one-device computation itself.

``ep`` is the reference's ``shard_map`` body with its collectives
explicit: the rows split over the data axes, each model shard keeps the
assignments to its ``E/m`` experts, the partial is summed over ``model``
in bfloat16, and the rows are gathered back (the port's streams are whole
on every rank). It regathers, per layer call, the experts it needs from
the placement above and frees them after. It needs a mesh.

Every shape is fixed by ``T`` and the config, and the dispatch uses no
``nonzero``, boolean-mask indexing or host read, so a stage holding it
captures as one CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as M


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


def _act(cfg: ModelConfig):
    """The experts' activation (``gelu`` is the tanh form, what
    ``jax.nn.gelu`` computes by default)."""
    if cfg.activation == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def _expert_ffn(p, x_disp, cfg: ModelConfig):
    """x_disp [E, C, D] -> [E, C, D], each expert's gated MLP."""
    g = _act(cfg)(torch.bmm(x_disp, p["w_gate"]))
    return torch.bmm(g * torch.bmm(x_disp, p["w_up"]), p["w_down"])


def _expert_ffn_sharded(p, x_disp, cfg: ModelConfig, mesh):
    """:func:`_expert_ffn` on this rank's shards of the placement: x_disp
    [E, C, D] whole -> (this rank's ``w_down`` partial [E, C, D], whether
    it must be summed over ``model``)."""
    E, C, D = x_disp.shape
    El, Dl = p["w_gate"].shape[0], p["w_gate"].shape[1]
    Fl = p["w_down"].shape[1]
    if El < E:                               # this rank's experts
        x_disp = x_disp.narrow(0, mesh.index("model") * El, El)
    if Dl < D:                               # this rank's d_model slice
        x_disp = x_disp.narrow(2, mesh.index("data") * Dl, Dl)
    gu = torch.stack([torch.bmm(x_disp, p["w_gate"]),
                      torch.bmm(x_disp, p["w_up"])])
    if Dl < D:
        gu = mesh.all_reduce(gu, "data")
    h = _act(cfg)(gu[0]) * gu[1]             # [El, C, F]
    if El < E:
        h = mesh.all_gather(h, "model", dim=0)
    if Fl < cfg.d_ff:                        # w_down's F-split layout
        h = h.narrow(2, mesh.index("model") * Fl, Fl)
    return torch.bmm(h, p["w_down"]), Fl < cfg.d_ff


def _combine(y, slot, keep, gates, n_slots: int):
    """The experts' rows [n_slots, D] weighted back to their tokens: the
    drop bin ``n_slots`` reads zeros."""
    y = torch.cat([y, y.new_zeros((1, y.shape[1]))])
    y_tok = y[torch.where(keep, slot, n_slots)]             # [T, k, D]
    return torch.einsum("tkd,tk->td", y_tok, gates * keep)


def _moe_gather(p, x2d, cfg: ModelConfig):
    """Capacity-slot dispatch, experts, combine. x2d [T, D] -> ([T, D],
    aux). On a mesh that splits the expert stacks, each rank computes its
    share (:func:`_expert_ffn_sharded`) and the output is summed over
    ``model`` here, not by the caller."""
    T, D = x2d.shape
    E = cfg.n_experts
    C = _capacity(T, cfg)
    gates, idx, aux = _route(p, x2d, cfg)
    slot, keep, inv = _dispatch_indices(idx, T, E, C)
    x_disp = torch.where((inv >= 0)[:, None], x2d[inv.clamp_min(0)], 0)
    x_disp = x_disp.reshape(E, C, D)
    mesh = M.active()
    if mesh is None or (p["w_gate"].shape[:2] == (E, D)
                        and p["w_down"].shape[1] == cfg.d_ff):
        y = _expert_ffn(p, x_disp, cfg)
        return _combine(y.reshape(E * C, D), slot, keep, gates, E * C), aux
    y, partial = _expert_ffn_sharded(p, x_disp, cfg, mesh)
    out = _combine(y.reshape(E * C, D), slot, keep, gates, E * C)
    return (mesh.all_reduce(out, "model") if partial else out), aux


def _ep_weights(p, cfg: ModelConfig, mesh, El: int) -> dict:
    """The expert stacks ``ep`` computes with: this model shard's ``El``
    experts, each whole, regathered from the placement (``w_gate`` /
    ``w_up`` over ``data`` when their ``D`` is split; ``w_down``'s ``F``
    over ``model``, one expert block a round so that no more than the
    rank's own block is ever held whole). Transient: freed with the call."""
    D, Fd = cfg.d_model, cfg.d_ff
    my, m = mesh.index("model"), mesh.shape["model"]
    out = {}
    for name in ("w_gate", "w_up"):
        w = p[name]
        if w.shape[0] != El:
            w = w.narrow(0, my * El, El)
        if w.shape[1] < D:
            w = mesh.all_gather(w, "data", dim=1)
        out[name] = w
    wd = p["w_down"]
    if wd.shape[1] < Fd:
        for c in range(m):
            blk = mesh.all_gather(wd.narrow(0, c * El, El), "model", dim=1)
            if c == my:
                out["w_down"] = blk
            del blk
    else:
        out["w_down"] = wd.narrow(0, my * El, El)
    return out


def _moe_ep(p, x2d, cfg: ModelConfig):
    """Expert parallelism (the reference's ``_moe_ep``): the rows split
    over the data axes, each model shard dispatching only to its own
    ``E/m`` experts with the capacity of its rows, the partials summed over
    ``model`` in bfloat16 and ``aux`` averaged there; then the rows are
    gathered back over the data axes, and ``aux`` is the first data
    shard's (the reference's replicated ``out_specs``)."""
    mesh = M.active()
    if mesh is None:
        raise ValueError("moe_impl='ep' needs a serving mesh (the "
                         "reference's needs an active mesh)")
    m, E = mesh.shape["model"], cfg.n_experts
    if E % m:
        raise ValueError(f"moe_impl='ep': {E} experts do not divide the "
                         f"{m}-way model axis")
    El = E // m
    dp = M.data_axes(mesh)
    n = M.axis_size(mesh, dp)
    T, D = x2d.shape
    if T % n:
        raise ValueError(f"moe_impl='ep': {T} rows do not divide the "
                         f"{n}-way data axes")
    Tl = T // n
    x = x2d.narrow(0, mesh.index(dp) * Tl, Tl)
    my, k = mesh.index("model"), cfg.experts_per_token
    gates, idx, aux = _route(p, x, cfg)
    # keep only the assignments to this shard's experts; the rest go to
    # the drop column El
    local = (idx // El) == my
    flat = torch.where(local, idx - my * El, El).reshape(-1)
    C = _capacity(Tl, cfg)
    counts = torch.cumsum(F.one_hot(flat, El + 1), dim=0)
    pos = counts.gather(1, flat[:, None])[:, 0] - 1
    keep = (flat < El) & (pos < C)
    slot = torch.where(keep, flat * C + pos, El * C)
    token_of = torch.arange(Tl, device=x.device).repeat_interleave(k)
    inv = torch.full((El * C + 1,), -1, dtype=torch.long, device=x.device)
    inv[slot] = token_of
    inv = inv[:-1]
    x_disp = torch.where((inv >= 0)[:, None], x[inv.clamp_min(0)], 0)
    y = _expert_ffn(_ep_weights(p, cfg, mesh, El),
                    x_disp.reshape(El, C, D), cfg)
    part = _combine(y.reshape(El * C, D), slot.reshape(Tl, k),
                    keep.reshape(Tl, k), gates, El * C)
    # the bfloat16 combine: each partial rounded, summed, rounded
    out = mesh.all_reduce(part.to(torch.bfloat16).float(), "model")
    out = out.to(torch.bfloat16).to(x.dtype)
    aux = mesh.all_reduce(aux.reshape(1), "model")[0] / m
    aux = mesh.all_gather(aux.reshape(1), dp)[0]
    return mesh.all_gather(out, dp, dim=0), aux


def moe_ffn(p, x, cfg: ModelConfig):
    """x [..., D] -> (out [..., D], aux_loss); the routing and capacity run
    over all of x's rows at once (``gather``), or over each data shard's
    (``ep``)."""
    D = x.shape[-1]
    x2d = x.reshape(-1, D)
    if cfg.moe_impl == "ep":
        out, aux = _moe_ep(p, x2d, cfg)
    else:
        out, aux = _moe_gather(p, x2d, cfg)
    return out.reshape(x.shape), aux
