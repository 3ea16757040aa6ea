"""Operations and bytes the yardstick counts, from the configuration's
sizes and the engine's counters.

What one Refresh or Reuse token multiplies is the configuration's
reference's to declare (``token_params(model)``): a dense stack's
projections, a mixture's router and the experts a token is routed to, a
hybrid's shared block once a call of it. It is read once at set-up
(:func:`token_params`) and carried by the run; nothing here knows a
family. The head is counted apart, the same for every family.
"""
from __future__ import annotations

from pathlib import Path

from sbench import spec


def token_params(config: dict, root: Path) -> int:
    """Parameters a Refresh or Reuse token's pass through the layer stack
    multiplies, as the configuration's reference counts them."""
    ref = spec.reference(config["reference"], root)
    return int(ref.token_params(config["model"]))


def step_flops(model: dict, row: dict, token_params: int) -> float:
    """One engine iteration's model FLOPs from its ``iter_log`` row: two a
    parameter a real Refresh or Reuse token multiplies, and the head's
    2·D·V a real logit row. Attention's scores are left out (a lower
    bound)."""
    tokens = row["refresh_tokens_real"] + row["reuse_tokens_real"]
    return (2.0 * token_params * tokens
            + logit_flops(model, row["logit_tokens_real"]))


def logit_flops(model: dict, rows: int) -> float:
    return 2.0 * rows * model["d_model"] * model["vocab_size"]


def logit_bytes(model: dict, rows: int, elem: int = 2) -> float:
    """One fused logit call: the head read once, the rows' hidden states
    read, an id, a max and a sum written a row."""
    D, V = model["d_model"], model["vocab_size"]
    return elem * (D * V + rows * D) + 12.0 * rows


def logit_bound_s(model: dict, rows: int, peak: dict) -> float:
    return max(logit_bytes(model, rows) / peak["hbm_bytes_s"],
               logit_flops(model, rows) / peak["bf16_flops"])
