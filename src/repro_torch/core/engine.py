"""dLLM-Serve execution engine: continuous batching over Refresh/Reuse phases
on one device, token-packed or padded.

One engine iteration (§4.1 workflow), as in ``repro.core.engine``:
  1. the scheduler builds an :class:`IterationPlan` under the query-token
     budget (C2) and its :class:`PackedIterationLayout`,
  2. the iteration's Refresh set runs as ONE ragged token stream: varlen
     self-attention, head-centric select/pack, and a scatter of the packed
     caches into the slot pool (C3),
  3. the Reuse set runs its active blocks as one ``[R·Sb]`` stream against
     the gathered slot caches,
  4. every active block's hidden rows are decoded through the budgeted logit
     stage (C1: ``max_num_logits`` sub-batches of the fused argmax kernel),
  5. ONE device->host copy brings the ids and confidences back into pinned
     memory behind an event; the request state machines advance at
     dispatch from commit counts alone, and the sync lands the values.

Each stage runs through a per-bucket entry (``core/graphs.py``), the
port's counterpart of the reference's per-bucket jits: its streams are
filled in numpy straight into the entry's pinned staging, reach its static
device inputs in one copy, and on the card replay one CUDA graph per
(stage, bucket) that holds the whole stage, the slot pool's scatter
(Refresh) or gather (Reuse) included. :meth:`Engine.warmup` captures every
bucket the runtime can request (:func:`stage_keys`). ``graphs=False`` runs
the same entries eagerly (the oracle the graphs are held to), and the CPU
always does. Two execution paths, as in the reference:

* token-packed (``varlen_pack=True``): one ragged stream per stage, as
  above;
* padded (``varlen_pack=False``, the oracle and the three baseline
  systems): Refresh in serial chunks of ``refresh_slots`` requests, each a
  pow2-padded ``[b, max_seq_len]`` batch; Reuse as one pow2-padded block
  batch whose pad rows read the scratch slot; the logit stage over the
  pow2 bucket of the rows (``monolithic``: one ``[N, V]`` pass).

On CUDA the attention and scan stages run their kernels:
``use_flash_kernel=True`` is required (``--kernels``); their plain
fallbacks run on the CPU only. The logit stage runs every C1 mode on the
card: ``fused`` in its kernel, ``chunked`` and ``monolithic`` as the
reference's plain jnp path, in torch ops. Every family the port registers
(dense, moe, ssm, hybrid, and the modality frontends vlm and audio) serves
on both paths. A frontend arch's requests carry ``frontend_len`` projected
rows ahead of their text: every Refresh spans ``F + text`` rows, and block
and Reuse positions count the prefix.

Mesh serving (``ServeConfig.mesh_shape = (data, model)`` or ``(pod,
data, model)``), as the reference's, for every family: one engine a rank
of ``launch.mesh.spawn``, each holding its shard of the weights
(``launch.sharding.Rules.params``) and of the slot pool
(``Rules.cache``: slots over the data-parallel axes together, heads or
retained length over ``model``). The stages run tensor-parallel over
``model`` (local heads, FFN hidden, inner width and vocabulary;
``layers.tp_sum`` after each row-parallel product; an MoE layer on the
expert placement, ``models.moe``) and replicate the streams over the
data axes. Every rank plans the same iterations: the host state is
identical, and on the wall clock rank 0's ``now`` is broadcast to every
rank once an iteration. The kernels' divisibility law is checked before
any group is built (``kernel_partition_plan``); int8 slots and gloo
ranks asked to capture graphs on the card raise. A ``(1, 1)`` or ``(1, 1,
1)`` mesh builds no group and is bit-identical to no mesh.

Robustness and the memory multipliers, as in the reference:

* ``faults`` (a :class:`~repro_torch.core.faults.FaultPlan`) is consumed at
  the reference's sites: each iteration ticks the schedule (a slow fault is
  charged to the modeled clock or slept), the scheduler defers admission on
  allocation faults and loses the slots a memory-pressure event steals,
  and a dispatch fault is raised before the stage's entry runs (under
  graphs: before its replay, so a retried stage replays once), retried
  with exponential backoff on the modeled clock (slept on the wall clock,
  at most 0.05 s) up to ``fault_retries`` attempts.
* ``prefix_sharing``: each Refresh row's content key goes through the
  pool's share ledger before the entry runs; the host rewrites the
  entry's slot-index input (a deduplicated row writes the scratch slot,
  a Reuse row reads its owner's row), and copy-on-write promotes are
  eager row copies on the serving stream, queued before the replay that
  overwrites the old owner.
* ``kv_quant="int8"``: the pool quantizes inside the Refresh entries'
  write and the Reuse entries dequantize at their KV load.

``ServeConfig.pipeline`` (the default) runs the reference's dispatch-ahead
loop: iteration i+1 is planned while iteration i runs on the device, then
i's one device->host copy is waited for, then i+1 is filled and
dispatched. ``pipeline=False`` syncs every iteration; both give the same
ids, counters and modeled clock.

``clock="modeled"`` advances a virtual device clock by the reference's cost
model (:class:`DeviceModel`) — a parity device, so the port's ``vtime``
matches the reference's exactly. It is no measurement of the card.
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import diffusion
from repro_torch.core.budgeting import (admission_block_reason,
                                        can_pack_tokens,
                                        pow2_bucket as _bucket,
                                        token_bucket_round)
from repro_torch.core.faults import FaultError, FaultPlan
from repro_torch.core.graphs import Field, HostResult, StageGraphs
from repro_torch.core.kv_pool import KVPool
from repro_torch.core.request import Outcome, Request, State
from repro_torch.core.scheduler import make_scheduler
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops as OPS
from repro_torch.kernels.flash_varlen import PAD_SEG
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import retained_axes
from repro_torch.models import backbone as BB
from repro_torch.models import layers as L
from repro_torch.models import lm_head as LM
from repro_torch.models import transformer as T
from repro_torch.params import init_params, shard_cut, shard_params


@dataclass(frozen=True)
class DeviceModel:
    """Virtual accelerator cost model of the reference's modeled clock:
    ``launch + flops/peak`` virtual seconds per device call."""
    launch_s: float = 1e-3
    peak_flops: float = 20e9

    def call_cost(self, flops: float, work_split: float = 1.0) -> float:
        return self.launch_s + flops / (self.peak_flops
                                        * max(1.0, work_split))


@dataclass
class EngineStats:
    """The reference's counters, field for field."""
    iterations: int = 0
    refresh_steps: int = 0
    reuse_steps: int = 0
    committed_tokens: int = 0
    deferred_steps: int = 0
    peak_query_tokens: int = 0
    wall_time: float = 0.0
    refresh_tokens_real: int = 0
    refresh_tokens_exec: int = 0
    reuse_tokens_real: int = 0
    reuse_tokens_exec: int = 0
    logit_tokens_real: int = 0
    logit_tokens_exec: int = 0
    packed_refresh_calls: int = 0
    padded_refresh_calls: int = 0
    packed_reuse_calls: int = 0
    padded_reuse_calls: int = 0
    submitted: int = 0
    finished: int = 0
    rejected_oversized: int = 0
    rejected_queue_full: int = 0
    shed_deadline: int = 0
    shed_queue: int = 0
    preemptions: int = 0
    recomputed_tokens: int = 0
    dispatch_retries: int = 0
    shared_hits: int = 0
    shared_cow_promotes: int = 0
    phys_slots_peak: int = 0
    alloc_fault_iters: int = 0
    slow_fault_s: float = 0.0
    # stage entries built per reference entry name (on the card with
    # graphs: captures); compiles_warmup snapshots the total when warmup
    # returns, so anything above it was built mid-serve
    compile_counts: Dict[str, int] = field(default_factory=dict)
    compiles_warmup: int = 0
    # host side of the serving loop, on the wall clock in either clock mode
    host_plan_s: float = 0.0      # building IterationPlans + packed layouts
    host_fill_s: float = 0.0      # stream fills + stage dispatch
    sync_wait_s: float = 0.0      # blocked in the iteration's device->host copy
    overlapped_host_s: float = 0.0
    dispatched_ahead: int = 0
    streamed_events: int = 0
    iter_log: List[dict] = field(default_factory=list)
    # replays per captured entry, "stage[bucket]" (the port's own key)
    graph_replays: Dict[str, int] = field(default_factory=dict)

    @property
    def compiles_total(self) -> int:
        return sum(self.compile_counts.values())

    @property
    def compiles_post_warmup(self) -> int:
        return self.compiles_total - self.compiles_warmup

    @property
    def overlap_frac(self) -> float:
        return self.overlapped_host_s / max(
            self.host_plan_s + self.host_fill_s, 1e-12)

    @property
    def rejected(self) -> int:
        return self.rejected_oversized + self.rejected_queue_full

    @property
    def shed(self) -> int:
        return self.shed_deadline + self.shed_queue

    def conserved(self) -> bool:
        return self.submitted == self.finished + self.shed + self.rejected

    @property
    def refresh_waste(self) -> float:
        return self.refresh_tokens_exec / max(self.refresh_tokens_real, 1)

    @property
    def reuse_waste(self) -> float:
        return self.reuse_tokens_exec / max(self.reuse_tokens_real, 1)

    @property
    def logit_waste(self) -> float:
        return self.logit_tokens_exec / max(self.logit_tokens_real, 1)

    @property
    def throughput(self) -> float:
        return self.committed_tokens / max(self.wall_time, 1e-9)


@dataclass
class _CommitEntry:
    """One request's dispatched commit: what the sync needs to land the
    token values (see ``repro.core.engine._CommitEntry``)."""
    req: Request
    row: int                  # request index in the decoded hidden stream
    block_start: int          # absolute offset of the committed block
    block_idx: int            # block index at dispatch (stream events)
    n_commit: int             # commit width passed to commit_tokens
    n_act: int                # positions actually unmasked (stats delta)
    epoch: int                # req.commit_epoch at dispatch
    finished: bool            # this commit completed the request
    t: float                  # commit timestamp (modeled vtime / wall now)


@dataclass
class _Prepared:
    now: float
    plan: object              # IterationPlan
    layout: object            # PackedIterationLayout | None
    lifecycle: bool           # the plan shed/rejected/preempted something
    plan_s: float

    @property
    def has_exec(self) -> bool:
        return self.plan.has_exec


@dataclass
class _Pending:
    """A dispatched iteration: the queued copy of its decode outputs (ids,
    then the confidences' bits, over ``n_rows`` rows each) plus the commit
    entries its sync applies."""
    result: Optional[HostResult]
    n_rows: int
    entries: List[_CommitEntry]
    log_row: dict


def _check_mesh_config(cfg: ModelConfig, serve: ServeConfig) -> None:
    """What a mesh cannot serve raises before any group or device is
    touched: a kernel dimension the model axis does not divide
    (``kernel_partition_plan``) and int8 slots (the reference's reason)."""
    if serve.mesh_model > 1 and (serve.use_flash_kernel
                                 or serve.logit_mode == "fused"):
        from repro_torch.launch.sharding import kernel_partition_plan
        kernel_partition_plan(cfg, serve)
    if serve.kv_quant != "none":
        raise NotImplementedError(
            "kv_quant='int8' is not yet composed with mesh serving — "
            "the quantized pool's scale leaves need their own "
            "Rules.cache-derived placement (see docs/memory.md)")


def _pow2s(hi: int) -> List[int]:
    out, b = [], 1
    while b <= hi:
        out.append(b)
        b *= 2
    return out


def stage_keys(serve: ServeConfig, cfg: ModelConfig) -> Dict[str, List[tuple]]:
    """Every (stage, bucket) key the engine can request under ``serve``,
    ascending. :meth:`Engine.warmup` builds the stages in this order
    (Refresh first: its warm run allocates the slot pool the Reuse entries
    gather from), each stage's keys largest first.

    The bounds: a packed Refresh fuses at most ``refresh_slots`` requests
    (``max_slots`` under the request-level scheduler) of at most
    ``max_seq_len`` tokens each, plus a frontend arch's ``frontend_len``
    prefix rows, and ``max_num_batched_tokens`` in all; a
    padded Refresh runs chunks of ``refresh_slots``; an iteration decodes
    distinct residents, each holding a slot, so Reuse and the logit stage
    see at most ``max_slots`` requests. Every token bucket under those
    bounds is listed, not only the reference's doubling."""
    S, Sb = serve.max_seq_len, serve.block_size
    F = cfg.frontend_len if cfg.frontend_dim else 0
    tb = max(1, serve.token_bucket)
    keys: Dict[str, List[tuple]] = {}
    if serve.varlen_pack and can_pack_tokens(cfg):
        r_fused = (serve.refresh_slots if serve.scheduler == "phase"
                   else serve.max_slots)
        top = lambda rp: max(tb, -(-min(  # noqa: E731
            rp * (S + F), serve.max_num_batched_tokens) // tb) * tb)
        keys["refresh_packed"] = [(tp, rp) for rp in _pow2s(_bucket(r_fused))
                                  for tp in range(tb, top(rp) + 1, tb)]
        rb = max(1, tb // Sb)
        keys["reuse_packed"] = sorted({(token_bucket_round(n, rb),)
                                       for n in range(1, serve.max_slots + 1)})
    else:
        keys["refresh"] = [(b,) for b in _pow2s(_bucket(serve.refresh_slots))]
        keys["reuse"] = [(b,) for b in _pow2s(_bucket(serve.max_slots))]
    if serve.varlen_pack:
        keys["decode_packed"] = sorted({
            (token_bucket_round(k * Sb, tb),)
            for k in range(1, serve.max_slots + 1)})
    else:
        keys["decode"] = [(Sb * b,) for b in _pow2s(
            _bucket(serve.max_slots * Sb, lo=Sb) // Sb)]
    return keys


class Engine:
    def __init__(self, cfg: ModelConfig, serve: ServeConfig,
                 params=None, seed: int = 0,
                 clock: Optional[str] = None,
                 device_model: Optional[DeviceModel] = None,
                 faults: Optional[FaultPlan] = None,
                 stream_cb: Optional[Callable] = None,
                 device="cuda", graphs: bool = True):
        """``faults`` is the run's injected fault schedule (None: none).
        ``stream_cb`` is called once per committed (request, iteration)
        at sync, when the values exist on the host, with the reference's
        event dict. ``graphs`` captures each (stage, bucket) entry as a CUDA
        graph on the card; ``graphs=False`` runs the same entries eagerly
        (the oracle), as the CPU always does."""
        if serve.kv_quant not in ("none", "int8"):
            raise ValueError(f"ServeConfig.kv_quant must be 'none' or "
                             f"'int8', got {serve.kv_quant!r}")
        if serve.mesh_shape is not None:
            _check_mesh_config(cfg, serve)
        self.device = devices.resolve(device)
        if self.device.type == "cuda" and not serve.use_flash_kernel:
            raise ValueError(
                "on CUDA the attention stages run their kernels: "
                "use_flash_kernel=False has none (use device='cpu' for the "
                "plain fallbacks)")
        self.cfg = cfg
        self.serve = serve
        self.clock = clock if clock is not None else serve.clock
        if self.clock not in ("wall", "modeled"):
            raise ValueError(f"Engine clock must be 'wall' or 'modeled', "
                             f"got {self.clock!r}")
        self.model = device_model or DeviceModel()
        self.vtime = 0.0
        self._n_params = cfg.n_active_params()
        # the serving mesh (None without one): this rank's, built by
        # launch.mesh.spawn; a one-device mesh in process, with no group
        self.mesh = M.serving_mesh(serve.mesh_shape, self.device)
        self.mesh_devices = self.mesh.size if self.mesh is not None else 1
        if self.mesh is not None and self.mesh.staged and graphs:
            raise ValueError(
                "ranks co-located on one GPU talk over gloo, whose "
                "collectives run on host tensors and cannot be captured in "
                "a CUDA graph: build the engine with graphs=False")
        rules = cut = None
        if self.mesh is not None:
            from repro_torch.launch.sharding import Rules
            rules = Rules(cfg, self.mesh, train=False)
            cut = shard_cut(rules, self.mesh)
        if params is None:
            # each leaf drawn whole (the one-device stream) and cut to this
            # rank's shard before the next is drawn
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device, cut=cut)
        retain = min(serve.retained_len,
                     serve.max_seq_len - serve.block_size)
        pool_spec, self._pool_pad = None, 0
        if self.mesh is not None:
            params = shard_params(params, rules, self.mesh)
            # the pool's slot axis shards over the data axes (pod x data):
            # pad it to a multiple
            self._pool_pad = (-(serve.max_slots + 1)) % serve.mesh_data
            pool_spec = rules.cache(
                serve.max_slots + 1 + self._pool_pad, retain,
                data_parallel=False, slot_data_parallel=True)
            self.mesh.kernel_dims = dict(
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                ssm_heads=cfg.ssm_heads if cfg.ssm_state else 0,
                vocab_size=cfg.vocab_size)
        self.params = params
        self.mask_id = diffusion.mask_token_id(cfg.vocab_size)
        self.ctx = T.ServeContext(
            block_size=serve.block_size, retain=retain,
            kernel_size=serve.kernel_size, selection=serve.selection,
            q_chunk=min(L.DEFAULT_Q_CHUNK, serve.max_seq_len),
            use_flash_kernel=serve.use_flash_kernel,
            max_seq_len=serve.max_seq_len,
            # a Reuse stage attends the rank's cut of the pool's retained
            # length and merges across the axes that cut it
            kv_split=retained_axes(pool_spec) if pool_spec else ())
        self._use_packed = serve.varlen_pack and can_pack_tokens(cfg)
        # the prefix rows of a frontend arch's request (0 for text-only
        # archs): every Refresh spans F + text rows, and block and Reuse
        # positions count them
        self._fe_len = cfg.frontend_len if cfg.frontend_dim else 0
        # the synthetic frontend payloads, drawn in submit order as the
        # reference's engine draws them
        self._rng = np.random.default_rng(seed)
        self.scheduler = make_scheduler(serve)
        self.pool = KVPool(serve.max_slots, self.device,
                           sharing=serve.prefix_sharing,
                           kv_quant=serve.kv_quant, mesh=self.mesh,
                           spec=pool_spec, pad_slots=self._pool_pad)
        # the modeled clock's credit for the mesh, the reference's: the
        # model axis splits the share of the weights it really shards (1.0
        # when nothing divides), the data axis carries mesh_data replica
        # streams of the slot pool
        self._tp_work_split = 1.0
        if serve.mesh_model > 1:
            from repro_torch.core.budgeting import weight_bytes_per_device
            self._tp_work_split = (
                weight_bytes_per_device(cfg, None)
                / max(1, weight_bytes_per_device(cfg,
                                                 (1, serve.mesh_model))))
        self._dp_work_split = (float(serve.mesh_data)
                               if self.mesh is not None
                               and serve.mesh_data > 1 else 1.0)
        self._sharing = serve.prefix_sharing
        # the scheduler drives the pool's take/free ledger and consumes the
        # fault plan's allocation faults and memory-pressure steals
        self.scheduler.pool = self.pool
        self.faults = faults
        self.scheduler.faults = faults
        self._iter = 0               # engine iteration (the fault schedule's)
        self._fault_blocked = False  # the last plan was held by faults
        self._stream_cb = stream_cb
        self.graphs = StageGraphs(self.device, graphs)
        self._hdtype = params["embed"]["table"].dtype
        self._ar = np.arange(serve.max_seq_len + self._fe_len, dtype=np.int32)
        self.stats = EngineStats()
        if serve.iter_log_cap:
            self.stats.iter_log = deque(maxlen=serve.iter_log_cap)
        self._rid_counter = itertools.count()

    @property
    def work_split(self) -> float:
        """Modeled work division across the mesh: the model axis's share
        times the data axis's replica streams (1.0 on one device)."""
        return self._tp_work_split * self._dp_work_split

    @property
    def kernels_active(self) -> bool:
        return bool(self.serve.use_flash_kernel
                    or self.serve.logit_mode == "fused")

    # ------------------------------------------------------------------
    # buckets (the reference's, so both packages run the same shapes)
    # ------------------------------------------------------------------
    def _token_bucket(self, n_tokens: int) -> int:
        """Round a real token count up to the packed-buffer granularity."""
        tb = max(1, self.serve.token_bucket)
        return max(tb, -(-n_tokens // tb) * tb)

    def _reuse_bucket(self, n_requests: int) -> int:
        """Packed-Reuse request count: R·block_size rounded to the token
        bucket (exact below one bucket)."""
        rb = max(1, self.serve.token_bucket // self.serve.block_size)
        return token_bucket_round(n_requests, rb)

    def _logit_bucket(self, n_rows: int) -> int:
        """Packed logit-stage rows: exact below one token bucket, whole
        buckets above."""
        return token_bucket_round(n_rows, self.serve.token_bucket)

    # ------------------------------------------------------------------
    # per-bucket stage entries (the reference's stage jits)
    # ------------------------------------------------------------------
    def _entry(self, name: str, key: tuple):
        return self.graphs.get(name, key, lambda: self._make(name, key))

    def _make(self, name: str, key: tuple):
        """Static input fields and function of one (stage, bucket). The
        Refresh entries end in the slot pool's scatter and the Reuse entries
        begin with its gather, so the captured caches never leave the
        graph; only block hidden rows and the decode outputs are static
        outputs."""
        S, Sb = self.serve.max_seq_len, self.serve.block_size
        F = self._fe_len
        i32, i64, b8 = torch.int32, torch.int64, torch.bool
        # a frontend arch's payloads, [b, F, frontend_dim] float32
        fe = ([Field("frontend", (key[-1], F, self.cfg.frontend_dim),
                     torch.float32)] if F else [])
        # the functions close over these, never over the engine: an entry
        # referring back to it would make a cycle only gc frees
        pool, scratch = self.pool, self.pool.scratch_slot
        P, cfg, ctx = self.params, self.cfg, self.ctx
        if name == "refresh_packed":
            tp, rp = key
            # padding requests point at the (invalid) tail so their gathers
            # stay in bounds; their caches land in the scratch slot
            fields = [Field("tokens", (tp,), i32), Field("pos", (tp,), i32),
                      Field("seg", (tp,), i32, PAD_SEG),
                      Field("valid", (tp,), b8, False),
                      Field("cu", (rp,), i32, max(0, tp - 1)),
                      Field("lens", (rp,), i32), Field("bstart", (rp,), i32),
                      Field("slots", (rp,), i64, scratch)] + fe

            def fn(x):
                out = BB.serve_refresh_packed(
                    P, cfg, x["tokens"], x["pos"], x["seg"], x["valid"],
                    x["cu"], x["lens"], x["bstart"], ctx,
                    frontend=x.get("frontend"))
                pool.write(x["slots"], out.cache)
                return out.block_hidden
        elif name == "refresh":
            (n,) = key
            fields = [Field("tokens", (n, S), i32),
                      Field("valid", (n, F + S), b8, False),
                      Field("bstart", (n,), i32),
                      Field("slots", (n,), i64, scratch)] + fe

            def fn(x):
                out = BB.serve_refresh(P, cfg, x["tokens"], x["bstart"], ctx,
                                       token_valid=x["valid"],
                                       frontend=x.get("frontend"))
                pool.write(x["slots"], out.cache)
                return out.block_hidden
        elif name in ("reuse_packed", "reuse"):
            (n,) = key
            shape = (n * Sb,) if name == "reuse_packed" else (n, Sb)
            fields = [Field("btok", shape, i32), Field("bpos", shape, i32),
                      Field("slots", (n,), i64, scratch)]
            stage = (BB.serve_reuse_packed if name == "reuse_packed"
                     else BB.serve_reuse)
            kv_quant = self.serve.kv_quant

            def fn(x):
                # the KV-load dequantization point (int8 pools): inside the
                # entry, so the dequantized caches are transient
                cache = OPS.dequantize_gathered(pool.gather(x["slots"]),
                                                kv_quant, pool.gathered_dtypes)
                return stage(P, cfg, x["btok"], x["bpos"], cache, ctx)
        elif name in ("decode_packed", "decode"):
            (n,) = key
            fields = [Field("h", (n, cfg.d_model), self._hdtype, host=False)]
            if name == "decode_packed":
                # the validity mask is an input: a Python row count baked
                # into a capture would hold for one count only
                fields.append(Field("valid", (n,), b8, False))
            sv = self.serve

            def fn(x):
                if name == "decode_packed":
                    ids, conf = LM.decode_tokens_packed(
                        P["embed"], cfg, x["h"], x["valid"],
                        max_num_logits=sv.max_num_logits, mode=sv.logit_mode)
                else:
                    ids, conf = LM.decode_tokens(
                        P["embed"], cfg, x["h"],
                        max_num_logits=sv.max_num_logits, mode=sv.logit_mode)
                return torch.cat([ids, conf.float().view(torch.int32)])
        else:
            raise KeyError(name)
        return fields, fn

    def _prepare(self, name: str, key: tuple, run: bool) -> None:
        """Build one entry on dummy inputs (the reference warmup's: every
        padding row at position 0, every request in the scratch slot) and
        warm and capture it; ``run`` also runs an eager entry once."""
        e = self._entry(name, key)
        x = e.host()
        if name == "refresh_packed":
            x["valid"][...] = True
            x["seg"][...] = 0
            x["cu"][...] = 0
            x["lens"][...] = min(key[0], self.serve.max_seq_len
                                 + self._fe_len)
        elif name in ("refresh", "decode_packed"):
            x["valid"][...] = True
        if e.captures:
            e.prepare()
        elif run:
            e()

    def warmup(self) -> float:
        """Build every stage entry the runtime can request
        (:func:`stage_keys`), so no entry is built inside the timed run: on
        the card with graphs each is warmed once eagerly and captured, each
        stage's largest bucket first. The eager paths run each stage's
        smallest bucket once (the library load and the slot pool's
        allocation). Dummy Refreshes write into the
        scratch slot only, which is zeroed after. Returns the seconds taken;
        ``stats.compiles_warmup`` snapshots the entries built."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            kbuild.library()
        for name, keys in stage_keys(self.serve, self.cfg).items():
            # largest bucket first: the shared graph pool's blocks freed by
            # a large capture serve the smaller ones after it
            for key in reversed(keys):
                self._prepare(name, key, run=key == keys[0])
        # a sharing pool's promote copy, once, before any serve needs it
        self.pool.warm_aux()
        self.pool.clear_slot(self.pool.scratch_slot)
        if self.device.type == "cuda":
            # warmup's end, before any serve: every capture finished
            torch.cuda.synchronize(self.device)  # lint: allow(host-sync)
        self.stats.compile_counts = dict(self.graphs.compile_counts)
        self.stats.compiles_warmup = self.stats.compiles_total
        return time.perf_counter() - t0

    def submit(self, prompt: np.ndarray, gen_len: int, arrival: float = 0.0,
               rid: Optional[int] = None, frontend=None,
               deadline: float = math.inf) -> Request:
        """Queue a request. A frontend arch's ``frontend`` carries the
        request's precomputed patch or frame embeddings ``[frontend_len,
        frontend_dim]``; omitted, a stand-in is drawn from the engine's
        rng, as the reference draws it. A request that can never be
        admitted comes back REJECTED with an ``error``, and is never
        enqueued."""
        if self.cfg.frontend_dim:
            if frontend is None:
                frontend = self._rng.standard_normal(
                    (self.cfg.frontend_len, self.cfg.frontend_dim)).astype(
                        np.float32)
            frontend = np.asarray(frontend, np.float32)
            if frontend.shape != (self.cfg.frontend_len,
                                  self.cfg.frontend_dim):
                raise ValueError(f"frontend of shape {frontend.shape}, "
                                 f"expected ({self.cfg.frontend_len}, "
                                 f"{self.cfg.frontend_dim})")
        elif frontend is not None:
            raise ValueError(f"{self.cfg.name} is text-only but got "
                             f"frontend embeddings")
        req = Request(rid=rid if rid is not None else next(self._rid_counter),
                      prompt=np.asarray(prompt, np.int32), gen_len=gen_len,
                      arrival=arrival, cfg=self.serve, mask_id=self.mask_id,
                      frontend=frontend, deadline=deadline)
        self.stats.submitted += 1
        reason = admission_block_reason(self.serve, req)
        if reason is not None:
            req.state = State.REJECTED
            req.outcome = Outcome.REJECTED_OVERSIZED
            req.error = reason
            self._tally(req)
            return req
        for casualty in self.scheduler.submit(req):
            self._tally(casualty)
        return req

    def _tally(self, req: Request) -> None:
        """Record a terminal outcome in the conservation counters."""
        o = req.outcome
        if o is Outcome.FINISHED:
            self.stats.finished += 1
        elif o is Outcome.REJECTED_OVERSIZED:
            self.stats.rejected_oversized += 1
        elif o is Outcome.REJECTED_QUEUE_FULL:
            self.stats.rejected_queue_full += 1
        elif o is Outcome.SHED_DEADLINE:
            self.stats.shed_deadline += 1
        elif o is Outcome.SHED_QUEUE:
            self.stats.shed_queue += 1
        else:
            raise AssertionError(f"tally of non-terminal request {req.rid}")

    def run(self, time_scale: float = 1.0, max_iters: int = 100_000,
            quiet: bool = True) -> EngineStats:
        """Serve until every submitted request is terminal. Wall clock:
        ``time_scale`` maps trace seconds to wall seconds; modeled clock:
        virtual seconds.

        Pipelined (``ServeConfig.pipeline``, the reference's loop): each lap
        (1) plans iteration i+1, host work that overlaps iteration i still
        running on the device, (2) waits for i's one device->host copy and
        lands its values (they must be in ``r.tokens`` before i+1's streams
        read them), then (3) fills and dispatches i+1, leaving its sync for
        the next lap. The control plane advanced at dispatch and depends on
        no token value, so scheduler, counters and vtime change in exactly
        the synchronous loop's order. ``pipeline=False`` syncs each lap."""
        start = time.perf_counter()
        pending: Optional[_Pending] = None
        it = 0
        while self.scheduler.has_work and it < max_iters:
            if self.clock == "modeled":
                now = self.vtime
            else:
                now = (time.perf_counter() - start) / time_scale
                if self.mesh is not None:
                    # every rank plans the iteration rank 0 plans
                    now = self.mesh.broadcast_float(now)
            prep = self._begin_iteration(now)
            if pending is not None:
                # the plan above was built while the previous dispatch was
                # still in flight
                self.stats.overlapped_host_s += prep.plan_s
                self.stats.dispatched_ahead += 1
                self._sync_iteration(pending)
                pending = None
            if prep.has_exec:
                nxt = self._dispatch_iteration(prep)
                if self.serve.pipeline:
                    pending = nxt
                else:
                    self._sync_iteration(nxt)
                progressed = True
            else:
                progressed = prep.lifecycle
            if not progressed:
                # time can unblock a future arrival or a future deadline
                events = [r.arrival for r in self.scheduler.waiting
                          if r.arrival > now]
                events += [r.deadline for r in self.scheduler.waiting
                           if now < r.deadline < math.inf]
                nxt = min(events, default=None)
                if nxt is None and self._fault_blocked:
                    # injected allocation faults or memory-pressure steals
                    # hold admission; the schedule is finite and advances
                    # per iteration, so spin: no stall
                    it += 1
                    continue
                if nxt is None:
                    raise RuntimeError(
                        f"engine stalled with work left at t={now:.3f}: "
                        f"{len(self.scheduler.running)} running / "
                        f"{len(self.scheduler.waiting)} waiting requests and "
                        f"an empty plan that no future arrival, deadline "
                        f"or fault schedule can unblock")
                if self.clock == "modeled":
                    self.vtime = max(self.vtime, nxt)
                else:
                    wait = nxt * time_scale - (time.perf_counter() - start)
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
            it += 1
        if pending is not None:
            # the last in-flight iteration drains outside the loop: a drain
            # lap would count one iteration more than the synchronous loop
            self._sync_iteration(pending)
        self.stats.wall_time = (self.vtime if self.clock == "modeled"
                                else time.perf_counter() - start)
        self.stats.iterations = it
        self.stats.compile_counts = dict(self.graphs.compile_counts)
        self.stats.graph_replays = self.graphs.replays
        if self.pool.ledger is not None:
            self.stats.shared_hits = self.pool.ledger.hits
            self.stats.shared_cow_promotes = self.pool.ledger.cow_promotes
            self.stats.phys_slots_peak = self.pool.phys_peak
        return self.stats

    # -- modeled-clock cost accounting -------------------------------------
    def _charge(self, kind: str, exec_tokens: int, kv_len: int = 0,
                actual_tokens: Optional[int] = None) -> None:
        """The reference's modeled-clock bill, term for term."""
        if self.clock != "modeled":
            return
        cfg = self.cfg
        # a stage is billed for real tokens only when its packed path ran;
        # the logit stage packs under varlen_pack for every family
        varlen = self.serve.varlen_pack and (kind == "decode"
                                             or self._use_packed)
        tokens = (actual_tokens if varlen
                  and actual_tokens is not None else exec_tokens)
        flops = 2.0 * self._n_params * tokens
        if cfg.has_attention and kv_len:
            dh = cfg.resolved_head_dim
            flops += 4.0 * tokens * kv_len * cfg.n_heads * dh \
                * cfg.n_layers
        if kind == "decode":
            rows = tokens if self.serve.logit_mode == "fused" \
                else exec_tokens
            flops = 2.0 * cfg.d_model * cfg.vocab_size * rows
        self.vtime += self.model.call_cost(flops, self.work_split)

    # ------------------------------------------------------------------
    # one engine iteration
    # ------------------------------------------------------------------
    def step(self, now: float) -> bool:
        """One synchronous iteration: plan -> dispatch -> sync. True when it
        executed work or a lifecycle event."""
        prep = self._begin_iteration(now)
        if not prep.has_exec:
            return prep.lifecycle
        self._sync_iteration(self._dispatch_iteration(prep))
        return True

    def _begin_iteration(self, now: float) -> _Prepared:
        """Plan one iteration: the fault schedule's tick, scheduler plan and
        packed layout (host work only)."""
        t0 = time.perf_counter()
        self._iter += 1
        if self.faults is not None:
            self.faults.begin_iteration(self._iter)
            d = self.faults.take_slow_delay()
            if d:
                self.stats.slow_fault_s += d
                if self.clock == "modeled":
                    self.vtime += d
                else:
                    time.sleep(min(d, 0.05))
        plan = self.scheduler.plan(now)
        for r in plan.rejected + plan.shed:
            self._tally(r)
        self.stats.preemptions += len(plan.preempted)
        self.stats.recomputed_tokens += plan.recomputed_tokens
        if plan.alloc_faults:
            self.stats.alloc_fault_iters += 1
        # a fault-held iteration is no stall: run() spins through it
        self._fault_blocked = plan.alloc_faults > 0 or (
            self.faults is not None and bool(self.scheduler.waiting)
            and self.faults.blocking())
        lifecycle = bool(plan.rejected or plan.shed or plan.preempted)
        layout = None
        if plan.has_exec:
            self.stats.deferred_steps += len(plan.deferred)
            self.stats.peak_query_tokens = max(self.stats.peak_query_tokens,
                                               plan.query_tokens)
            if self._use_packed:
                layout = plan.packed_layout(self.serve.refresh_slots)
        plan_s = time.perf_counter() - t0
        self.stats.host_plan_s += plan_s
        return _Prepared(now, plan, layout, lifecycle, plan_s)

    def _dispatch_iteration(self, prep: _Prepared) -> _Pending:
        """Fill the stage streams, run every stage's entry, queue the
        decode outputs' copy to the host, charge the modeled clock and
        advance the control plane. Each stage's block hidden rows are copied
        into the logit entry's static input right after its replay."""
        t0 = time.perf_counter()
        now, plan, layout = prep.now, prep.plan, prep.layout
        Sb = self.serve.block_size
        packed = self.serve.varlen_pack
        decoded: List[Request] = list(plan.refresh) + list(plan.reuse)
        N = n_real = len(decoded) * Sb
        dec = h = None
        if decoded:
            # packed: token-bucket rounding + a validity mask; padded: the
            # pow2 row bucket
            b = self._logit_bucket(N) if packed else _bucket(N, lo=Sb)
            dec = self._entry("decode_packed" if packed else "decode", (b,))
            h = dec.inputs["h"]
        row = 0

        # ---- Refresh: ONE fused packed dispatch / padded per-cap chunks ----
        iter_real = iter_exec = 0
        seg = layout.refresh_fused if self._use_packed else None
        if seg is not None:
            chunk = list(seg.requests)
            t_real = seg.total_tokens
            exec_tokens = self._run_refresh_packed(
                seg, h[row: row + len(chunk) * Sb])
            row += len(chunk) * Sb
            # the varlen kernel skips tiles of other segments: attention
            # costs Σ Sᵢ², the token-weighted mean segment length; the
            # plain fallback is billed for the whole [T, T] rectangle
            if self.ctx.use_flash_kernel:
                kv_len = sum(r.refresh_len ** 2
                             for r in chunk) // max(t_real, 1)
            else:
                kv_len = exec_tokens
            self.stats.refresh_steps += len(chunk)
            iter_real += t_real
            iter_exec += exec_tokens
            self._charge("refresh", exec_tokens, kv_len=kv_len,
                         actual_tokens=t_real)
        elif not self._use_packed:
            cap = self.serve.refresh_slots
            for i in range(0, len(plan.refresh), cap):
                chunk = plan.refresh[i: i + cap]
                t_real = sum(r.refresh_len for r in chunk)
                exec_tokens = self._run_refresh(
                    chunk, h[row: row + len(chunk) * Sb])
                row += len(chunk) * Sb
                self.stats.refresh_steps += len(chunk)
                iter_real += t_real
                iter_exec += exec_tokens
                self._charge("refresh", exec_tokens,
                             kv_len=self.serve.max_seq_len + self._fe_len,
                             actual_tokens=t_real)

        # ---- Reuse: one ragged block stream (packed) / pow2 batch ----
        r_real = r_exec = 0
        if plan.reuse:
            r_real = len(plan.reuse) * Sb
            dst = h[row: row + r_real]
            if self._use_packed:
                r_exec = self._run_reuse_packed(layout.reuse, dst)
            else:
                r_exec = self._run_reuse(plan.reuse, dst)
            self.stats.reuse_steps += len(plan.reuse)
            self._charge("reuse", r_exec,
                         kv_len=self.ctx.retain + self.serve.block_size,
                         actual_tokens=r_real)

        # ---- budgeted logit stage (C1) over every active block ----
        n_exec = 0
        result = None
        if decoded:
            if b != N:
                h[N:].zero_()
            x = dec.host()
            if packed:
                x["valid"][:N] = True
            result = dec.to_host(self._dispatch("decode", dec))
            # C1: serial sub-batches serialize on the device; monolithic
            # runs one big call (launch amortized, memory unbounded)
            if self.serve.logit_mode == "monolithic":
                self._charge("decode", b, actual_tokens=N)
                n_exec = b
            else:
                sub = self.serve.max_num_logits
                for off in range(0, b, sub):
                    act = max(0, min(sub, N - off))
                    if act == 0 and packed:
                        break   # a packed engine never launches all-pad chunks
                    self._charge("decode", min(sub, b - off),
                                 actual_tokens=act)
                    n_exec += min(sub, b - off)
            self.stats.logit_tokens_real += n_real
            self.stats.logit_tokens_exec += n_exec

        entries = self._advance_control(
            decoded, self.vtime if self.clock == "modeled" else now)
        fill_s = time.perf_counter() - t0
        self.stats.host_fill_s += fill_s
        log_row = dict(
            t=now, q_tokens=plan.query_tokens,
            n_refresh=len(plan.refresh), n_reuse=len(plan.reuse),
            n_logits=N,
            refresh_tokens_real=iter_real, refresh_tokens_exec=iter_exec,
            reuse_tokens_real=r_real, reuse_tokens_exec=r_exec,
            logit_tokens_real=n_real, logit_tokens_exec=n_exec,
            plan_s=prep.plan_s, fill_s=fill_s, sync_s=0.0)
        self.stats.iter_log.append(log_row)
        return _Pending(result, b if decoded else 0, entries, log_row)

    def _advance_control(self, decoded: List[Request],
                         t_commit: float) -> List[_CommitEntry]:
        """Advance every scheduled request's state machine from commit
        counts alone; the entries carry what the sync needs to land the
        token values."""
        entries: List[_CommitEntry] = []
        for j, r in enumerate(decoded):
            steps_left = self.serve.steps_per_block - r.step_in_block
            n_commit = diffusion.commit_count(r.masked_left, steps_left)
            e = _CommitEntry(req=r, row=j, block_start=r.block_start,
                             block_idx=r.block_idx, n_commit=n_commit,
                             n_act=0, epoch=r.commit_epoch, finished=False,
                             t=t_commit)
            e.n_act = r.advance_control(n_commit, t_commit)
            self.stats.committed_tokens += e.n_act
            e.finished = r.state == State.FINISHED
            if e.finished:
                self.scheduler.finish(r)
                self._tally(r)
            entries.append(e)
        return entries

    def _sync_iteration(self, pending: _Pending) -> None:
        """The iteration's one wait: for the queued copy of the ids and the
        confidences' bits (on the card, an event behind the copy into
        pinned memory). Then each entry's values land in its recorded block
        (dropped if a rollback bumped the epoch), and stream events fire."""
        if pending.result is None:
            return
        t0 = time.perf_counter()
        host = pending.result.wait()
        sync_s = time.perf_counter() - t0
        self.stats.sync_wait_s += sync_s
        pending.log_row["sync_s"] = sync_s
        n = pending.n_rows
        ids, conf = host[:n], host[n:].view(np.float32)
        Sb = self.serve.block_size
        for e in pending.entries:
            if e.req.commit_epoch != e.epoch:
                continue
            rid = ids[e.row * Sb: (e.row + 1) * Sb]
            rconf = conf[e.row * Sb: (e.row + 1) * Sb]
            s = e.block_start
            newblk = diffusion.commit_tokens(e.req.tokens[s: s + Sb], rid,
                                             rconf, e.n_commit, self.mask_id)
            e.req.tokens[s: s + Sb] = newblk
            if self._stream_cb is not None:
                self.stats.streamed_events += 1
                self._stream_cb(dict(
                    rid=e.req.rid, t=e.t, block_idx=e.block_idx,
                    n_committed=e.n_act, finished=e.finished,
                    tokens=np.array(newblk)))
        pending.result.release()

    def _dispatch(self, stage: str, call: Callable):
        """Run one stage entry under the fault plan: an injected dispatch
        fault is raised before ``call`` runs (before a graph's replay, so a
        retried stage runs once), then retried with exponential backoff,
        charged to the modeled clock or slept on the wall clock (at most
        0.05 s), up to ``fault_retries`` attempts; past them the
        :class:`FaultError` propagates. Without a plan, a plain call."""
        if self.faults is None:
            return call()
        attempt = 0
        while True:
            attempt += 1
            try:
                if self.faults.take_dispatch_fault(stage):
                    raise FaultError(
                        f"injected {stage} dispatch fault "
                        f"(iter {self._iter}, attempt {attempt})")
                return call()
            except FaultError:
                if attempt >= self.serve.fault_retries:
                    raise
                self.stats.dispatch_retries += 1
                backoff = self.model.launch_s * (2 ** (attempt - 1))
                if self.clock == "modeled":
                    self.vtime += backoff
                else:
                    time.sleep(min(backoff, 0.05))

    def _refresh(self, e, x, chunk: List[Request]):
        """Dispatch a filled Refresh entry. With sharing, its requests'
        content keys go through the share ledger first (inside the
        dispatch, so once per stage whatever the retries): promotes are
        queued as row copies ahead of the replay, and a deduplicated row's
        slot input becomes the scratch slot. Padding rows keep the scratch
        slot and bypass the ledger."""
        def call():
            if self._sharing:
                x["slots"][: len(chunk)] = self.pool.route_shared(
                    [r.slot for r in chunk],
                    [r.refresh_key() for r in chunk])
            return e()
        return self._dispatch("refresh", call)

    # ------------------------------------------------------------------
    def _check_slots(self, reqs: List[Request]) -> None:
        """Slot-handle integrity guard before any pool write or gather."""
        for r in reqs:
            if r.slot is None or r.slot_gen is None:
                raise RuntimeError(
                    f"stale slot handle: request {r.rid} scheduled with no "
                    f"slot (state={r.state})")
            gen = self.pool.generation(r.slot)
            if gen != r.slot_gen:
                raise RuntimeError(
                    f"stale slot handle: request {r.rid} holds slot "
                    f"{r.slot}@gen{r.slot_gen} but the pool is at gen {gen}")

    def _run_refresh(self, chunk: List[Request], dst: torch.Tensor) -> int:
        """Padded Refresh: a pow2 request bucket of ``[b, max_seq_len]``
        rows (a frontend arch's batch is ``[b, F + max_seq_len]``, the
        prefix first); the pad rows' caches land in the scratch slot.
        Copies the block hidden rows into ``dst`` [n·Sb, D]; returns the
        executed tokens, b·(F + max_seq_len)."""
        n = len(chunk)
        b = _bucket(n)
        S, F = self.serve.max_seq_len, self._fe_len
        self._check_slots(chunk)
        e = self._entry("refresh", (b,))
        x = e.host()
        for j, r in enumerate(chunk):
            x["tokens"][j] = r.tokens
            x["valid"][j, : F + r.total_len] = True
            x["bstart"][j] = F + r.block_start
            x["slots"][j] = r.slot
            if F:
                x["frontend"][j] = r.frontend
        dst.copy_(self._refresh(e, x, chunk)[:n].reshape(dst.shape))
        self.stats.padded_refresh_calls += 1
        self.stats.refresh_tokens_real += sum(r.refresh_len for r in chunk)
        self.stats.refresh_tokens_exec += b * (F + S)
        return b * (F + S)

    def _run_refresh_packed(self, seg_layout, dst: torch.Tensor) -> int:
        """Token-packed Refresh: one ragged stream bucketed on total tokens,
        each request a segment of ``[F placeholder tokens ; text]`` for a
        frontend arch (the stage writes the projected frontend over the
        placeholders' rows; padding requests keep ``lens`` 0, so they write
        none). Copies the block hidden rows into ``dst``; returns the
        executed tokens."""
        chunk = list(seg_layout.requests)
        cu_real = seg_layout.cu_seqlens
        n = len(chunk)
        rp = _bucket(n)
        t_real = seg_layout.total_tokens
        tp = self._token_bucket(t_real)
        F = self._fe_len
        self._check_slots(chunk)
        e = self._entry("refresh_packed", (tp, rp))
        x = e.host()
        for j, r in enumerate(chunk):
            off = int(cu_real[j])
            ln = r.refresh_len               # frontend prefix + text
            assert ln == int(cu_real[j + 1]) - off, "layout/request mismatch"
            x["tokens"][off + F: off + ln] = r.tokens[: r.total_len]
            x["pos"][off: off + ln] = self._ar[:ln]
            x["seg"][off: off + ln] = j
            x["valid"][off: off + ln] = True
            x["cu"][j] = off
            x["lens"][j] = ln
            x["bstart"][j] = F + r.block_start
            x["slots"][j] = r.slot
            if F:
                x["frontend"][j] = r.frontend
        dst.copy_(self._refresh(e, x, chunk)[:n].reshape(dst.shape))
        self.stats.packed_refresh_calls += 1
        self.stats.refresh_tokens_real += t_real
        self.stats.refresh_tokens_exec += tp
        return tp

    def _run_reuse_packed(self, seg_layout, dst: torch.Tensor) -> int:
        """Token-packed Reuse: the active blocks as one ``[R·Sb]`` stream,
        R rounded to the token-bucket granularity (scratch slots back the
        padding segments). Copies the hidden rows into ``dst``; returns
        rp·Sb."""
        reqs = list(seg_layout.requests)
        n = len(reqs)
        Sb = self.serve.block_size
        rp = self._reuse_bucket(n)
        self._check_slots(reqs)
        e = self._entry("reuse_packed", (rp,))
        x = e.host()
        for j, r in enumerate(reqs):
            off = int(seg_layout.cu_seqlens[j])
            s = self._fe_len + r.block_start
            x["btok"][off: off + Sb] = r.block_tokens()
            x["bpos"][off: off + Sb] = self._ar[s: s + Sb]
        # referrers read their owner's row
        x["slots"][:n] = self.pool.resolve([r.slot for r in reqs])
        dst.copy_(self._dispatch("reuse", e)[: n * Sb])
        self.stats.packed_reuse_calls += 1
        self.stats.reuse_tokens_real += n * Sb
        self.stats.reuse_tokens_exec += rp * Sb
        return rp * Sb

    def _run_reuse(self, reqs: List[Request], dst: torch.Tensor) -> int:
        """Padded Reuse: a pow2 request bucket whose pad rows read the
        scratch slot. Copies the hidden rows into ``dst``; returns b·Sb."""
        n = len(reqs)
        b = _bucket(n)
        Sb = self.serve.block_size
        self._check_slots(reqs)
        e = self._entry("reuse", (b,))
        x = e.host()
        for j, r in enumerate(reqs):
            s = self._fe_len + r.block_start
            x["btok"][j] = r.block_tokens()
            x["bpos"][j] = self._ar[s: s + Sb]
        x["slots"][:n] = self.pool.resolve([r.slot for r in reqs])
        dst.copy_(self._dispatch("reuse", e)[:n].reshape(dst.shape))
        self.stats.padded_reuse_calls += 1
        self.stats.reuse_tokens_real += n * Sb
        self.stats.reuse_tokens_exec += b * Sb
        return b * Sb
