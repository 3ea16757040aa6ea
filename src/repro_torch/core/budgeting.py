"""The pure budgeting helpers of ``repro.core.budgeting`` the packed path uses.

The offline memory profiler (``plan_memory`` / ``size_slots``) is not ported
yet: the reference computes its byte counts with ``jax.eval_shape`` over the
parameter tree, and the port's counterpart comes with a later slice
(ROADMAP Queue A).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ServeConfig


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power-of-two multiple of ``lo`` that is ≥ n."""
    b = lo
    while b < n:
        b *= 2
    return b


def token_bucket_round(n: int, bucket: int) -> int:
    """Packed-stream rounding: exact below one bucket, ceil to bucket
    multiples above, never beyond the pow2 bucket."""
    n = max(1, n)
    b = max(1, bucket)
    r = n if n <= b else -(-n // b) * b
    return min(r, pow2_bucket(n))


def logit_exec_tokens(serve: ServeConfig, n_logit_tokens: int) -> int:
    """Rows the decode dispatch materializes for ``n`` real hidden rows."""
    n = max(1, n_logit_tokens)
    if serve.varlen_pack:
        return token_bucket_round(n, serve.token_bucket)
    return pow2_bucket(n, lo=serve.block_size)


def can_pack_tokens(cfg: ModelConfig) -> bool:
    """True when the token-packed Refresh/Reuse paths apply to ``cfg``
    (every family in the reference; the single opt-out point)."""
    del cfg
    return True


def admission_block_reason(serve: ServeConfig, req) -> "str | None":
    """Why ``req`` can NEVER be admitted under ``serve`` (None = admittable)."""
    if req.total_len > serve.max_seq_len:
        return (f"total_len {req.total_len} (prompt {req.prompt_len} + gen "
                f"{req.gen_len}) exceeds max_seq_len {serve.max_seq_len}")
    if req.refresh_len > serve.max_num_batched_tokens:
        return (f"Refresh cost {req.refresh_len} (frontend {req.frontend_len}"
                f" + total {req.total_len}) exceeds the token budget "
                f"max_num_batched_tokens={serve.max_num_batched_tokens}; "
                f"the request can never be scheduled")
    return None
