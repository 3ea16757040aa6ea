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
it in. Under ``ServeConfig.mesh_shape`` every term is per device, as in
the reference: weights and slot bytes follow the ``launch.sharding.Rules``
specs (over a :class:`~repro_torch.launch.mesh.SimMesh`, so any mesh is
planned from one process), the logit and backbone reservations shrink
with the vocabulary, FFN and heads the model axis divides, and the slot
count is per data replica times ``mesh_data``. The memory multipliers are
the reference's: int8 ``kv_quant`` bills the KV leaves at one byte an element
plus a float32 scale per (layer, slot), and ``prefix_sharing`` multiplies
the physical slots by the trace's measured ``share_factor``.

:func:`measure_logit_peak` measures each C1 mode's logit-stage peak on the
card (the reference reads it from an XLA compile).

:class:`DeviceBill` is the port's own, beside the plan: what a warmed serve
holds on the card (its weights, the engine's slot pool at the serving
geometry, the captured graphs' pool, the stage entries' device staging,
the measured logit peak of an eager serve) with the plan's activation
reservation, held against the budget the plan was given.
``launch.serve.run_serve`` re-sizes or refuses a serve that exceeds it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ServeConfig


_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "bool": 1}
GUARD_BAND = 0.03        # share of device memory the plan leaves unused


def dtype_bytes(dtype: str) -> int:
    return _BYTES[dtype]


def _tp_div(n: int, m: int) -> int:
    """Shard count the model axis gives a dimension of size ``n``: ``m`` on
    exact division (the ``Rules.div`` law), else 1."""
    return m if m > 1 and n and n % m == 0 and n >= m else 1


def _sharded_bytes(mesh, shape, spec, itemsize: int,
                   quant: bool = False) -> int:
    """Per-device bytes of one leaf: each dimension divided (ceil) by the
    combined size of the mesh axes its spec entry names. An int8-quantized
    leaf is one byte an element plus its ``[L, B]`` float32 scale, billed
    whole (the cache rules never shard those two axes within a slot)."""
    from repro_torch.launch.sharding import spec_axes
    total = 1 if quant else itemsize
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        shards = 1
        for a in spec_axes(entry):
            shards *= mesh.shape[a]
        total *= -(-dim // shards)
    if quant:
        total += shape[0] * shape[1] * 4
    return total


def _shape_leaves(tree) -> list:
    """The shape leaves of a ``params.shapes`` tree, in ``spec_leaves``
    order (sorted keys)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shape_leaves(tree[k])]
    return [tuple(tree)]


@functools.lru_cache(maxsize=None)
def weight_bytes_per_device(cfg: ModelConfig, mesh_shape=None) -> int:
    """Parameter bytes of one device under the serving placement
    (``Rules.params``, serve time) of ``mesh_shape`` (None: one device):
    every leaf of ``params.shapes(cfg)`` in ``cfg.dtype``, the dtype
    ``init_params`` draws them in."""
    from repro_torch.launch.mesh import SimMesh
    from repro_torch.launch.sharding import Rules, spec_leaves
    from repro_torch.params import shapes
    mesh = SimMesh(tuple(mesh_shape) if mesh_shape else (1, 1))
    tree = shapes(cfg)
    specs = spec_leaves(Rules(cfg, mesh, train=False).params(tree))
    b = dtype_bytes(cfg.dtype)
    return sum(_sharded_bytes(mesh, shape, spec, b)
               for shape, spec in zip(_shape_leaves(tree), specs))


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
    by executed rows (the engine's bucketing, not the real count).
    Vocab-parallel under a mesh: a device holds its ``[n, V/m]`` shard."""
    n_exec = logit_exec_tokens(serve, n_logit_tokens)
    V = cfg.vocab_size // _tp_div(cfg.vocab_size, serve.mesh_model)
    if serve.logit_mode == "monolithic":
        return n_exec * V * 4           # the full [N, V] float32 logits
    if serve.logit_mode == "chunked":
        return min(n_exec, serve.max_num_logits) * V * 4
    # fused: the reference's online kernel holds one [256, vocab_tile]
    # float32 block
    return 256 * serve.vocab_tile * 4


def _slot_cache_shapes(cfg: ModelConfig, serve: ServeConfig, retain: int):
    """``(shape, dtype, quant)`` of every leaf of one slot of the engine's
    pool: the family's cache tree with its leading layer axis and a slot
    axis of 1. Keys and values in ``serve.dtype``, positions int32,
    validity bool, SSM states float32, conv tails in ``serve.dtype``;
    ``quant`` marks the leaves int8 storage quantizes (``PackedKV``
    keys and values: ``kernels.kv_quant.quant_mask``)."""
    dt = serve.dtype

    def kv(nl):
        kshape = (nl, 1, cfg.n_kv_heads, retain, cfg.resolved_head_dim)
        return [(kshape, dt, True), (kshape, dt, True),
                (kshape[:-1], "int32", False), (kshape[:-1], "bool", False)]

    def ssm():
        from repro_torch.models.ssm import conv_channels
        return [((cfg.n_layers, 1, cfg.ssm_heads, cfg.ssm_head_dim,
                  cfg.ssm_state), "float32", False),
                ((cfg.n_layers, 1, cfg.ssm_conv_kernel - 1,
                  conv_channels(cfg)), dt, False)]

    if cfg.family == "ssm":
        return ssm()
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import group_shape
        return ssm() + kv(group_shape(cfg)[0])
    return kv(cfg.n_layers)


def kv_slot_bytes(cfg: ModelConfig, serve: ServeConfig) -> int:
    """Static per-request cache region (§4.5): the bytes of one slot at the
    engine's retained length ``min(retained_len, max_seq_len -
    block_size)``, per device under a mesh by the pool's own
    ``Rules.cache`` specs (KV heads over ``model``, else the retained
    length; SSM states over their heads; nothing over ``data`` within a
    slot). Under int8 ``kv_quant`` the quantized leaves are billed at one
    byte an element plus their ``[L, 1]`` float32 scale."""
    from repro_torch.launch.mesh import SimMesh
    from repro_torch.launch.sharding import Rules, spec_leaves
    retain = min(serve.retained_len,
                 max(1, serve.max_seq_len - serve.block_size))
    mesh = SimMesh(serve.mesh_shape or (1, 1))
    specs = spec_leaves(Rules(cfg, mesh, train=False).cache(
        1, retain, data_parallel=False))
    int8 = serve.kv_quant == "int8"
    return sum(_sharded_bytes(mesh, shape, spec, dtype_bytes(dt),
                              quant=int8 and quant)
               for (shape, dt, quant), spec in zip(
                   _slot_cache_shapes(cfg, serve, retain), specs))


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
    tokens, double-buffered. Under a mesh the FFN hidden and the heads
    shrink by the model axis where it divides them; the ``[T, 3D]`` stream
    stays whole."""
    m = serve.mesh_model
    T = max(max_exec_tokens(serve, cfg), reuse_exec_tokens(serve, cfg))
    width = max(cfg.d_ff // _tp_div(cfg.d_ff, m),
                cfg.n_heads * cfg.resolved_head_dim
                // _tp_div(cfg.n_heads, m),
                3 * cfg.d_model)
    return T * width * dtype_bytes(serve.dtype) * 2


@dataclass(frozen=True)
class MemoryPlan:
    """The reference's plan, field for field: bytes per device, slots
    global."""
    weights_bytes: int
    activation_bytes: int       # reserved (incl. the logit stage's mode)
    logit_bytes: int
    slot_bytes: int             # bytes of one slot
    kv_pool_bytes: int
    max_slots: int              # LOGICAL concurrent-request capacity
    mesh_devices: int = 1
    # the memory multipliers: the physical slots the pool bytes fit, and
    # the sharing / quantization knobs that turned them into max_slots
    phys_slots: int = 0
    share_factor: float = 1.0
    kv_quant: str = "none"

    def summary(self) -> str:
        gb = 1 << 30
        mesh = f" mesh={self.mesh_devices}dev" if self.mesh_devices > 1 else ""
        share = (f" share={self.share_factor:.2f}x"
                 if self.share_factor != 1.0 else "")
        quant = f" kv={self.kv_quant}" if self.kv_quant != "none" else ""
        return (f"weights={self.weights_bytes/gb:.2f}GiB/dev "
                f"act={self.activation_bytes/gb:.3f}GiB "
                f"(logit={self.logit_bytes/gb:.3f}GiB) "
                f"kv_pool={self.kv_pool_bytes/gb:.2f}GiB "
                f"slots={self.max_slots}{mesh}{share}{quant}")


def plan_memory(cfg: ModelConfig, serve: ServeConfig, hbm_bytes: int,
                guard_band: float = GUARD_BAND,
                share_factor: float = 1.0) -> MemoryPlan:
    """The offline profiler's output: the activation reservation (for
    ``max_num_batched_tokens`` query rows all needing logits) and the KV
    pool that the rest of ``hbm_bytes`` holds, capped at
    ``serve.max_slots``.

    ``share_factor`` is the workload's measured logical/physical occupancy
    ratio (``data.workloads.prefix_share_factor``): with
    ``serve.prefix_sharing`` on, every physical slot backs that many
    logical residents on average, so the plan multiplies capacity before
    the cap. int8 ``serve.kv_quant`` instead shrinks ``slot_bytes``, so
    more physical slots fit outright. Under a mesh ``hbm_bytes`` is one
    device's memory, and the pool's slot axis shards over the data axes
    (pod × data): the slots are each replica's times ``mesh_data``."""
    weights = weight_bytes_per_device(cfg, serve.mesh_shape)
    logit = logit_activation_bytes(cfg, serve, serve.max_num_batched_tokens)
    act = backbone_activation_bytes(cfg, serve) + logit
    guard = int(hbm_bytes * guard_band)
    slot = kv_slot_bytes(cfg, serve)
    pool = max(0, hbm_bytes - weights - act - guard)
    replicas = max(1, serve.mesh_data)
    phys = replicas * (pool // slot) if slot else serve.max_slots
    share = share_factor if serve.prefix_sharing else 1.0
    slots = min(serve.max_slots, int(phys * share))
    return MemoryPlan(weights, act, logit, slot, pool, int(slots),
                      mesh_devices=serve.mesh_devices,
                      phys_slots=int(min(serve.max_slots, phys)),
                      share_factor=share, kv_quant=serve.kv_quant)


@dataclass(frozen=True)
class DeviceBill:
    """The bytes a warmed serve holds on the card, against the budget its
    plan was given less the guard band: the weights the engine holds; the
    engine's
    own slot pool (its slots and the scratch slot, each ``slot_bytes`` at
    the serving geometry: what the engine allocated); the larger of the
    plan's activation reservation (at the profiler's geometry, its logit
    term measured for an eager serve on the card) and the captured graph
    pool, which holds a captured serve's activations; and the stage
    entries' device staging. ``plan_kv_pool_bytes`` is the plan's pool for
    the same slots at the profiler's geometry and ``plan_weights_bytes``
    the plan's weights, both beside the bill, not in it."""
    budget_bytes: int           # hbm_bytes less GUARD_BAND
    weights_bytes: int
    kv_pool_bytes: int          # slot_bytes x (slots + the scratch slot)
    activation_bytes: int
    graph_pool_bytes: int
    staging_bytes: int          # the stage entries' device inputs
    slot_bytes: int             # one slot of the engine's pool
    slots: int
    plan_kv_pool_bytes: int     # the plan's slot bytes x slots
    plan_weights_bytes: int     # the plan's weights, beside the bill

    @property
    def total_bytes(self) -> int:
        return (self.weights_bytes + self.kv_pool_bytes
                + max(self.activation_bytes, self.graph_pool_bytes)
                + self.staging_bytes)

    @property
    def excess_bytes(self) -> int:
        return max(0, self.total_bytes - self.budget_bytes)

    @property
    def fits(self) -> bool:
        return self.excess_bytes == 0

    @property
    def slots_over(self) -> int:
        """Slots to drop to pay for the excess: ``ceil(excess /
        slot_bytes)``."""
        return -(-self.excess_bytes // max(1, self.slot_bytes))

    def as_dict(self) -> dict:
        return dict(budget_bytes=self.budget_bytes,
                    weights_bytes=self.weights_bytes,
                    kv_pool_bytes=self.kv_pool_bytes,
                    activation_bytes=self.activation_bytes,
                    graph_pool_bytes=self.graph_pool_bytes,
                    staging_bytes=self.staging_bytes,
                    slot_bytes=self.slot_bytes, slots=self.slots,
                    plan_kv_pool_bytes=self.plan_kv_pool_bytes,
                    plan_weights_bytes=self.plan_weights_bytes,
                    total_bytes=self.total_bytes,
                    excess_bytes=self.excess_bytes, fits=self.fits)


def bill_device(plan: MemoryPlan, hbm_bytes: int, slots: int,
                slot_bytes: int, weights_bytes: int,
                graph_pool_bytes: int = 0, staging_bytes: int = 0,
                logit_peak: "int | None" = None,
                pool_rows: "int | None" = None) -> DeviceBill:
    """The bill of a serve of ``slots`` slots of ``slot_bytes`` each (the
    engine's pool, ``KVPool.slot_bytes``) planned by ``plan`` on
    ``hbm_bytes``: the weights the engine holds (``weights_bytes``, its
    parameters' bytes: a reduced or cut serve holds less than the full
    config the plan sized slots for) and the
    plan's activation reservation, with
    ``logit_peak`` (a measured logit-stage peak, ``measure_logit_peak``)
    in place of the plan's ``logit_bytes`` when given, plus the pool, the
    captured graphs' pool and the staging bytes. On a mesh the bill is one
    device's: ``plan`` and ``slot_bytes`` are per device, and
    ``pool_rows`` is the rows of the pool that device holds (default
    ``slots + 1``, the scratch slot's included)."""
    act = plan.activation_bytes
    if logit_peak is not None:
        act += int(logit_peak) - plan.logit_bytes
    return DeviceBill(
        budget_bytes=hbm_bytes - int(hbm_bytes * GUARD_BAND),
        weights_bytes=int(weights_bytes),
        kv_pool_bytes=int(slot_bytes) * (slots + 1 if pool_rows is None
                                         else pool_rows),
        activation_bytes=act,
        graph_pool_bytes=int(graph_pool_bytes),
        staging_bytes=int(staging_bytes), slot_bytes=int(slot_bytes),
        slots=slots, plan_kv_pool_bytes=plan.slot_bytes * slots,
        plan_weights_bytes=plan.weights_bytes)


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
        # an offline measurement: the stream drained around each mode
        torch.cuda.synchronize(dev)  # lint: allow(host-sync)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ids, conf = LM.decode_tokens(params, cfg, h,
                                     max_num_logits=serve.max_num_logits,
                                     mode=mode)
        torch.cuda.synchronize(dev)  # lint: allow(host-sync)
        out[mode] = torch.cuda.max_memory_allocated(dev) - base
        del ids, conf
    return out
