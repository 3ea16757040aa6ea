"""Operations and bytes the yardstick counts, from the configuration's
sizes and the engine's counters."""
from __future__ import annotations


def non_embedding_params(model: dict) -> int:
    """Parameters a token's pass through the layer stack multiplies: the
    attention projections (and their biases), the gated MLP and the two
    norms of every layer, and the final norm. The embedding lookup is no
    product and the head is counted by :func:`logit_flops`."""
    L, D, F = model["n_layers"], model["d_model"], model["d_ff"]
    H, K = model["n_heads"], model["n_kv_heads"]
    dh = model.get("head_dim") or D // H
    attn = D * H * dh + 2 * D * K * dh + H * dh * D
    if model.get("qkv_bias"):
        attn += H * dh + 2 * K * dh
    return L * (attn + 3 * D * F + 2 * D) + D


def step_flops(model: dict, row: dict) -> float:
    """One engine iteration's model FLOPs from its ``iter_log`` row: two a
    parameter a real Refresh or Reuse token, and the head's 2·D·V a real
    logit row. Attention's scores are left out (a lower bound)."""
    tokens = row["refresh_tokens_real"] + row["reuse_tokens_real"]
    return (2.0 * non_embedding_params(model) * tokens
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
