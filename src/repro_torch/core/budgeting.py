"""Logit-Aware Activation Budgeting and the offline memory profiler (paper
§4.2-4.3), as ``repro.core.budgeting``.

The profiler maps the memory envelope under worst-case serving pressure and
returns a :class:`MemoryPlan`: the bytes reserved for transient activations
(dominated by the logit stage under each C1 mode) and how many KV slots fit
in the rest. Decomposing the logit tensor shrinks the reservation, and the
reclaimed bytes become more concurrent requests: the paper's capacity
coupling, reproduced by arithmetic rather than hard-coded.

Byte counts come from shapes alone: the parameter tree of
``repro_torch.params.shapes`` and the slot pool's own cache geometry
(:func:`_slot_cache_shapes`), each leaf billed in the dtype the engine keeps
it in. One device: the reference's per-device sums over its sharding rules
reduce to plain sums. Mesh serving, prefix sharing and int8 slots are not
ported, and the profiler raises on them rather than bill something else.

:func:`measure_logit_peak` measures each C1 mode's logit-stage peak on the
card (the reference reads it from an XLA compile).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ServeConfig


_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "bool": 1}
GUARD_BAND = 0.03        # share of device memory the plan leaves unused


def dtype_bytes(dtype: str) -> int:
    return _BYTES[dtype]


def _require_one_device(serve: ServeConfig) -> None:
    """The profiler bills one device with plain slots; what it cannot bill
    raises (the engine raises on the same options)."""
    if serve.mesh_shape is not None:
        raise NotImplementedError(
            "plan_memory: mesh serving is not ported yet (ROADMAP Queue A, "
            "'multi-GPU')")
    if serve.prefix_sharing or serve.kv_quant != "none":
        raise NotImplementedError(
            "plan_memory: prefix sharing / int8 KV slots are not ported yet "
            "(ROADMAP Queue A, 'robustness and the memory multipliers')")


def _tree_elems(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_elems(t) for t in tree.values())
    return math.prod(tree)


@functools.lru_cache(maxsize=None)
def weight_bytes_per_device(cfg: ModelConfig) -> int:
    """Parameter bytes of the one device: every leaf of
    ``params.shapes(cfg)`` in ``cfg.dtype`` (the dtype ``init_params``
    draws them in)."""
    from repro_torch.params import shapes
    return _tree_elems(shapes(cfg)) * dtype_bytes(cfg.dtype)


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


def logit_activation_bytes(cfg: ModelConfig, serve: ServeConfig,
                           n_logit_tokens: int) -> int:
    """Peak bytes of the output-projection stage under each C1 mode, billed
    by executed rows (the engine's bucketing, not the real count)."""
    _require_one_device(serve)
    n_exec = logit_exec_tokens(serve, n_logit_tokens)
    V = cfg.vocab_size
    if serve.logit_mode == "monolithic":
        return n_exec * V * 4           # the full [N, V] float32 logits
    if serve.logit_mode == "chunked":
        return min(n_exec, serve.max_num_logits) * V * 4
    # fused: the reference's online kernel holds one [256, vocab_tile]
    # float32 block
    return 256 * serve.vocab_tile * 4


def _slot_cache_shapes(cfg: ModelConfig, serve: ServeConfig, retain: int):
    """``(shape, dtype)`` of every leaf of one slot of the engine's pool:
    the family's cache tree with its leading layer axis and a slot axis of
    1. Keys and values in ``serve.dtype``, positions int32, validity bool,
    SSM states float32, conv tails in ``serve.dtype``."""
    dt = serve.dtype

    def kv(nl):
        kshape = (nl, 1, cfg.n_kv_heads, retain, cfg.resolved_head_dim)
        return [(kshape, dt), (kshape, dt), (kshape[:-1], "int32"),
                (kshape[:-1], "bool")]

    def ssm():
        from repro_torch.models.ssm import conv_channels
        return [((cfg.n_layers, 1, cfg.ssm_heads, cfg.ssm_head_dim,
                  cfg.ssm_state), "float32"),
                ((cfg.n_layers, 1, cfg.ssm_conv_kernel - 1,
                  conv_channels(cfg)), dt)]

    if cfg.family == "ssm":
        return ssm()
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import group_shape
        return ssm() + kv(group_shape(cfg)[0])
    return kv(cfg.n_layers)


def kv_slot_bytes(cfg: ModelConfig, serve: ServeConfig) -> int:
    """Static per-request cache region (§4.5): the bytes of one slot at the
    engine's retained length ``min(retained_len, max_seq_len -
    block_size)``."""
    _require_one_device(serve)
    retain = min(serve.retained_len,
                 max(1, serve.max_seq_len - serve.block_size))
    return sum(math.prod(shape) * dtype_bytes(dt)
               for shape, dt in _slot_cache_shapes(cfg, serve, retain))


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


def max_exec_tokens(serve: ServeConfig, cfg: ModelConfig) -> int:
    """Worst-case tokens one Refresh dispatch materializes activations for:
    the token-bucketed budget when packed, else the padded rectangle of
    ``refresh_slots`` rows of ``max_seq_len`` (plus a frontend prefix)."""
    if serve.varlen_pack and can_pack_tokens(cfg):
        tb = max(1, serve.token_bucket)
        return -(-serve.max_num_batched_tokens // tb) * tb
    fe = cfg.frontend_len if cfg.frontend_dim else 0
    return max(serve.max_num_batched_tokens,
               pow2_bucket(serve.refresh_slots) * (serve.max_seq_len + fe))


def reuse_exec_tokens(serve: ServeConfig, cfg: ModelConfig) -> int:
    """Worst-case tokens one Reuse dispatch materializes activations for:
    whole token buckets of requests when packed, the pow2 batch bucket
    when padded."""
    Sb = max(1, serve.block_size)
    r_max = max(1, min(serve.max_slots, serve.max_num_batched_tokens // Sb))
    if serve.varlen_pack and can_pack_tokens(cfg):
        rb = max(1, serve.token_bucket // Sb)
        return token_bucket_round(r_max, rb) * Sb
    return pow2_bucket(r_max) * Sb


def backbone_activation_bytes(cfg: ModelConfig, serve: ServeConfig) -> int:
    """Workspace for attention and MLP over the widest stage's executed
    tokens, double-buffered."""
    _require_one_device(serve)
    T = max(max_exec_tokens(serve, cfg), reuse_exec_tokens(serve, cfg))
    width = max(cfg.d_ff, cfg.n_heads * cfg.resolved_head_dim,
                3 * cfg.d_model)
    return T * width * dtype_bytes(serve.dtype) * 2


@dataclass(frozen=True)
class MemoryPlan:
    """The reference's plan, field for field (one device: ``mesh_devices``
    1, ``share_factor`` 1.0, ``kv_quant`` "none")."""
    weights_bytes: int
    activation_bytes: int       # reserved (incl. the logit stage's mode)
    logit_bytes: int
    slot_bytes: int             # bytes of one slot
    kv_pool_bytes: int
    max_slots: int              # concurrent-request capacity
    mesh_devices: int = 1
    phys_slots: int = 0
    share_factor: float = 1.0
    kv_quant: str = "none"

    def summary(self) -> str:
        gb = 1 << 30
        return (f"weights={self.weights_bytes/gb:.2f}GiB/dev "
                f"act={self.activation_bytes/gb:.3f}GiB "
                f"(logit={self.logit_bytes/gb:.3f}GiB) "
                f"kv_pool={self.kv_pool_bytes/gb:.2f}GiB "
                f"slots={self.max_slots}")


def plan_memory(cfg: ModelConfig, serve: ServeConfig,
                hbm_bytes: int) -> MemoryPlan:
    """The offline profiler's output: the activation reservation (for
    ``max_num_batched_tokens`` query rows all needing logits) and the KV
    pool that the rest of ``hbm_bytes`` holds, capped at
    ``serve.max_slots``."""
    _require_one_device(serve)
    weights = weight_bytes_per_device(cfg)
    logit = logit_activation_bytes(cfg, serve, serve.max_num_batched_tokens)
    act = backbone_activation_bytes(cfg, serve) + logit
    guard = int(hbm_bytes * GUARD_BAND)
    slot = kv_slot_bytes(cfg, serve)
    pool = max(0, hbm_bytes - weights - act - guard)
    phys = pool // slot if slot else serve.max_slots
    slots = min(serve.max_slots, phys)
    return MemoryPlan(weights, act, logit, slot, pool, int(slots),
                      phys_slots=int(slots))


def measure_logit_peak(cfg: ModelConfig, serve: ServeConfig, n_tokens: int,
                       device="cuda") -> dict:
    """Peak device bytes of the logit stage in each C1 mode, measured: the
    allocator's peak above its baseline around ``lm_head.decode_tokens`` of
    ``n_tokens`` rows, with only the head weights (random) and the rows
    resident. The CPU has no such counter: raises there."""
    import torch
    from repro_torch import device as devices
    from repro_torch.models import lm_head as LM
    from repro_torch.params import DTYPES

    dev = devices.resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_logit_peak reads the CUDA allocator's "
                           "peak; it has no counterpart on the CPU")
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(0)
    V, D = cfg.vocab_size, cfg.d_model
    params = {"table": torch.empty((V, D), dtype=dtype, device=dev)
              .normal_(0, 0.02, generator=gen)}
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.empty((D, V), dtype=dtype, device=dev) \
            .normal_(0, 0.02, generator=gen)
    h = torch.randn((n_tokens, D), generator=gen, device=dev).to(dtype)
    out = {}
    for mode in ("monolithic", "chunked", "fused"):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ids, conf = LM.decode_tokens(params, cfg, h,
                                     max_num_logits=serve.max_num_logits,
                                     mode=mode)
        torch.cuda.synchronize(dev)
        out[mode] = torch.cuda.max_memory_allocated(dev) - base
        del ids, conf
    return out
