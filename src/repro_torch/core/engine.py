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
  5. ONE device->host copy brings the ids and confidences back, commits are
     applied host-side and the request state machines advance.

Stage streams are filled in numpy and copied to the device once per stream;
the pool write and gather stay on the device. Two execution paths, as in the
reference:

* token-packed (``varlen_pack=True``): one ragged stream per stage, as
  above;
* padded (``varlen_pack=False``, the oracle and the three baseline
  systems): Refresh in serial chunks of ``refresh_slots`` requests, each a
  pow2-padded ``[b, max_seq_len]`` batch; Reuse as one pow2-padded block
  batch whose pad rows read the scratch slot; the logit stage over the
  pow2 bucket of the rows (``monolithic``: one ``[N, V]`` pass).

On CUDA the stages run their kernels: ``use_flash_kernel=True`` and
``logit_mode="fused"`` are required (``--kernels``); the plain fallbacks
and the other logit modes run on the CPU only. The scan families serve on
the packed path only. The pipelined loop, mesh serving, fault injection,
prefix sharing and int8 KV raise ``NotImplementedError`` (ROADMAP Queue A).

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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import diffusion
from repro_torch.core.budgeting import (admission_block_reason,
                                        can_pack_tokens,
                                        pow2_bucket as _bucket,
                                        token_bucket_round)
from repro_torch.core.kv_pool import KVPool, tree_map
from repro_torch.core.request import Outcome, Request, State
from repro_torch.core.scheduler import make_scheduler
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_varlen import PAD_SEG
from repro_torch.models import backbone as BB
from repro_torch.models import layers as L
from repro_torch.models import lm_head as LM
from repro_torch.models import transformer as T
from repro_torch.params import init_params


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
    """The reference's counters, field for field (the ones this slice never
    moves stay 0)."""
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
    n_commit: int             # commit width passed to commit_tokens
    epoch: int                # req.commit_epoch at dispatch


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
    """A dispatched iteration: decode outputs still on the device plus the
    commit entries its sync applies."""
    ids: Optional[torch.Tensor]
    conf: Optional[torch.Tensor]
    entries: List[_CommitEntry]
    log_row: dict


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A, "
                               f"'{item}')")


class Engine:
    def __init__(self, cfg: ModelConfig, serve: ServeConfig,
                 params=None, seed: int = 0,
                 clock: Optional[str] = None,
                 device_model: Optional[DeviceModel] = None,
                 faults=None, device="cuda"):
        if faults is not None:
            raise _not_ported("fault injection",
                              "robustness and the memory multipliers")
        if serve.pipeline:
            raise _not_ported("the pipelined loop (pipeline=True)",
                              "the pipelined loop")
        if serve.mesh_shape is not None:
            raise _not_ported("mesh serving", "multi-GPU")
        if serve.prefix_sharing or serve.kv_quant != "none":
            raise _not_ported("prefix sharing / int8 KV",
                              "robustness and the memory multipliers")
        if cfg.family in ("ssm", "hybrid") and not (
                serve.varlen_pack and serve.use_flash_kernel):
            raise _not_ported(
                f"the {cfg.family} family's padded path and fallbacks "
                f"(varlen_pack=False or use_flash_kernel=False)",
                "the scan families' padded branches")
        self.device = devices.resolve(device)
        if self.device.type == "cuda" and not serve.use_flash_kernel:
            raise ValueError(
                "on CUDA the attention stages run their kernels: "
                "use_flash_kernel=False has none (use device='cpu' for the "
                "plain fallbacks)")
        if self.device.type == "cuda" and serve.logit_mode != "fused":
            raise ValueError(
                f"on CUDA the logit stage runs the fused kernel: "
                f"logit_mode={serve.logit_mode!r} has no kernel (use "
                f"device='cpu' for the plain modes)")
        self.cfg = cfg
        self.serve = serve
        self.clock = clock if clock is not None else serve.clock
        if self.clock not in ("wall", "modeled"):
            raise ValueError(f"Engine clock must be 'wall' or 'modeled', "
                             f"got {self.clock!r}")
        self.model = device_model or DeviceModel()
        self.vtime = 0.0
        self._n_params = cfg.n_active_params()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.mask_id = diffusion.mask_token_id(cfg.vocab_size)
        retain = min(serve.retained_len,
                     serve.max_seq_len - serve.block_size)
        self.ctx = T.ServeContext(
            block_size=serve.block_size, retain=retain,
            kernel_size=serve.kernel_size, selection=serve.selection,
            q_chunk=min(L.DEFAULT_Q_CHUNK, serve.max_seq_len),
            use_flash_kernel=serve.use_flash_kernel,
            max_seq_len=serve.max_seq_len)
        self._use_packed = serve.varlen_pack and can_pack_tokens(cfg)
        self.mesh_devices = 1
        self.scheduler = make_scheduler(serve)
        self.pool = KVPool(serve.max_slots, self.device)
        self.scheduler.pool = self.pool
        self.stats = EngineStats()
        if serve.iter_log_cap:
            self.stats.iter_log = deque(maxlen=serve.iter_log_cap)
        self._rid_counter = itertools.count()

    @property
    def work_split(self) -> float:
        """Modeled work division across devices: 1.0 on one device."""
        return 1.0

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

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """One host->device copy of a filled numpy stream."""
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def warmup(self) -> float:
        """Build the kernels (on CUDA) and run each stage once at its
        smallest bucket, on the path the engine serves, so the first served
        iteration pays no library load, pool allocation or first-touch
        cost. The dummy Refresh writes zeros into the scratch slot only.
        Returns the seconds taken."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            kbuild.library()
        S, Sb = self.serve.max_seq_len, self.serve.block_size
        i32 = lambda n, v=0: np.full((n,), v, np.int32)  # noqa: E731
        if self._use_packed:
            tp = self._token_bucket(min(S, self.serve.max_num_batched_tokens))
            out = BB.serve_refresh_packed(
                self.params, self.cfg, self._dev(i32(tp)), self._dev(i32(tp)),
                self._dev(i32(tp)), self._dev(np.ones((tp,), bool)),
                self._dev(i32(1)), self._dev(i32(1, min(tp, S))),
                self._dev(i32(1)), self.ctx)
        else:
            out = BB.serve_refresh(
                self.params, self.cfg, self._dev(np.zeros((1, S), np.int32)),
                self._dev(i32(1)), self.ctx,
                token_valid=self._dev(np.ones((1, S), bool)))
        self.pool.write([self.pool.scratch_slot],
                        tree_map(torch.zeros_like, out.cache))
        if self._use_packed:
            rp = self._reuse_bucket(1)
            BB.serve_reuse_packed(
                self.params, self.cfg, self._dev(i32(rp * Sb)),
                self._dev(i32(rp * Sb)),
                self.pool.gather([self.pool.scratch_slot] * rp), self.ctx)
        else:
            blk = self._dev(np.zeros((1, Sb), np.int32))
            BB.serve_reuse(self.params, self.cfg, blk, blk,
                           self.pool.gather([self.pool.scratch_slot]),
                           self.ctx)
        h = torch.zeros((Sb, self.cfg.d_model), dtype=out.block_hidden.dtype,
                        device=self.device)
        if self.serve.varlen_pack:
            n = self._logit_bucket(Sb)
            LM.decode_tokens_packed(
                self.params["embed"], self.cfg, F.pad(h, (0, 0, 0, n - Sb)),
                self._dev(np.ones((n,), bool)),
                max_num_logits=self.serve.max_num_logits,
                mode=self.serve.logit_mode)
        else:
            LM.decode_tokens(self.params["embed"], self.cfg, h,
                             max_num_logits=self.serve.max_num_logits,
                             mode=self.serve.logit_mode)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def submit(self, prompt: np.ndarray, gen_len: int, arrival: float = 0.0,
               rid: Optional[int] = None, frontend=None,
               deadline: float = math.inf) -> Request:
        """Queue a request. A request that can never be admitted comes back
        REJECTED with an ``error``, and is never enqueued."""
        if frontend is not None or self.cfg.frontend_dim:
            raise _not_ported("modality frontends", "MoE and frontends")
        req = Request(rid=rid if rid is not None else next(self._rid_counter),
                      prompt=np.asarray(prompt, np.int32), gen_len=gen_len,
                      arrival=arrival, cfg=self.serve, mask_id=self.mask_id,
                      deadline=deadline)
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
        """Serve until every submitted request is terminal. Each lap plans,
        dispatches and syncs one iteration. Wall clock: ``time_scale`` maps
        trace seconds to wall seconds; modeled clock: virtual seconds."""
        start = time.perf_counter()
        it = 0
        while self.scheduler.has_work and it < max_iters:
            if self.clock == "modeled":
                now = self.vtime
            else:
                now = (time.perf_counter() - start) / time_scale
            prep = self._begin_iteration(now)
            if prep.has_exec:
                self._sync_iteration(self._dispatch_iteration(prep))
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
                if nxt is None:
                    raise RuntimeError(
                        f"engine stalled with work left at t={now:.3f}: "
                        f"{len(self.scheduler.running)} running / "
                        f"{len(self.scheduler.waiting)} waiting requests and "
                        f"an empty plan that no future arrival or deadline "
                        f"can unblock")
                if self.clock == "modeled":
                    self.vtime = max(self.vtime, nxt)
                else:
                    wait = nxt * time_scale - (time.perf_counter() - start)
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
            it += 1
        self.stats.wall_time = (self.vtime if self.clock == "modeled"
                                else time.perf_counter() - start)
        self.stats.iterations = it
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
        """Plan one iteration: scheduler plan and packed layout (host work
        only)."""
        t0 = time.perf_counter()
        plan = self.scheduler.plan(now)
        for r in plan.rejected + plan.shed:
            self._tally(r)
        self.stats.preemptions += len(plan.preempted)
        self.stats.recomputed_tokens += plan.recomputed_tokens
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
        """Fill the stage streams, launch every stage, charge the modeled
        clock and advance the control plane."""
        t0 = time.perf_counter()
        now, plan, layout = prep.now, prep.plan, prep.layout
        hidden_rows: List[torch.Tensor] = []
        decoded: List[Request] = []

        # ---- Refresh: ONE fused packed dispatch / padded per-cap chunks ----
        iter_real = iter_exec = 0
        seg = layout.refresh_fused if self._use_packed else None
        if seg is not None:
            chunk = list(seg.requests)
            t_real = seg.total_tokens
            bh, exec_tokens = self._run_refresh_packed(seg)
            # the varlen kernel skips tiles of other segments: attention
            # costs Σ Sᵢ², the token-weighted mean segment length; the
            # plain fallback is billed for the whole [T, T] rectangle
            if self.ctx.use_flash_kernel:
                kv_len = sum(r.refresh_len ** 2
                             for r in chunk) // max(t_real, 1)
            else:
                kv_len = exec_tokens
            hidden_rows.append(bh)
            decoded.extend(chunk)
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
                bh, exec_tokens = self._run_refresh(chunk)
                hidden_rows.append(bh)
                decoded.extend(chunk)
                self.stats.refresh_steps += len(chunk)
                iter_real += t_real
                iter_exec += exec_tokens
                self._charge("refresh", exec_tokens,
                             kv_len=self.serve.max_seq_len,
                             actual_tokens=t_real)

        # ---- Reuse: one ragged block stream (packed) / pow2 batch ----
        r_real = r_exec = 0
        if plan.reuse:
            r_real = len(plan.reuse) * self.serve.block_size
            if self._use_packed:
                bh, r_exec = self._run_reuse_packed(layout.reuse)
            else:
                bh, r_exec = self._run_reuse(plan.reuse)
            hidden_rows.append(bh)
            decoded.extend(plan.reuse)
            self.stats.reuse_steps += len(plan.reuse)
            self._charge("reuse", r_exec,
                         kv_len=self.ctx.retain + self.serve.block_size,
                         actual_tokens=r_real)

        # ---- budgeted logit stage (C1) over every active block ----
        n_real = n_exec = 0
        ids = conf = None
        if decoded:
            D = self.cfg.d_model
            N = n_real = len(decoded) * self.serve.block_size
            packed = self.serve.varlen_pack
            # packed: token-bucket rounding + a validity mask; padded: the
            # pow2 row bucket
            b = (self._logit_bucket(N) if packed
                 else _bucket(N, lo=self.serve.block_size))
            h = torch.cat([r.reshape(-1, D) for r in hidden_rows], dim=0)
            if b != N:
                h = F.pad(h, (0, 0, 0, b - N))
            if packed:
                valid = torch.arange(b, device=self.device) < N
                ids, conf = LM.decode_tokens_packed(
                    self.params["embed"], self.cfg, h, valid,
                    max_num_logits=self.serve.max_num_logits,
                    mode=self.serve.logit_mode)
            else:
                ids, conf = LM.decode_tokens(
                    self.params["embed"], self.cfg, h,
                    max_num_logits=self.serve.max_num_logits,
                    mode=self.serve.logit_mode)
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
            n_logits=len(decoded) * self.serve.block_size,
            refresh_tokens_real=iter_real, refresh_tokens_exec=iter_exec,
            reuse_tokens_real=r_real, reuse_tokens_exec=r_exec,
            logit_tokens_real=n_real, logit_tokens_exec=n_exec,
            plan_s=prep.plan_s, fill_s=fill_s, sync_s=0.0)
        self.stats.iter_log.append(log_row)
        return _Pending(ids, conf, entries, log_row)

    def _advance_control(self, decoded: List[Request],
                         t_commit: float) -> List[_CommitEntry]:
        """Advance every scheduled request's state machine from commit
        counts alone; the entries carry what the sync needs to land the
        token values."""
        entries: List[_CommitEntry] = []
        for j, r in enumerate(decoded):
            steps_left = self.serve.steps_per_block - r.step_in_block
            n_commit = diffusion.commit_count(r.masked_left, steps_left)
            entries.append(_CommitEntry(
                req=r, row=j, block_start=r.block_start, n_commit=n_commit,
                epoch=r.commit_epoch))
            self.stats.committed_tokens += r.advance_control(n_commit,
                                                             t_commit)
            if r.state == State.FINISHED:
                self.scheduler.finish(r)
                self._tally(r)
        return entries

    def _sync_iteration(self, pending: _Pending) -> None:
        """The iteration's one device->host copy: ids and the bits of the
        confidences in one int32 buffer. Then each entry's values land in
        its recorded block (dropped if a rollback bumped the epoch)."""
        if pending.ids is None:
            return
        t0 = time.perf_counter()
        n = pending.ids.shape[0]
        both = torch.cat([pending.ids, pending.conf.view(torch.int32)])
        host = both.cpu().numpy()
        ids, conf = host[:n], host[n:].view(np.float32)
        sync_s = time.perf_counter() - t0
        self.stats.sync_wait_s += sync_s
        pending.log_row["sync_s"] = sync_s
        Sb = self.serve.block_size
        for e in pending.entries:
            if e.req.commit_epoch != e.epoch:
                continue
            rid = ids[e.row * Sb: (e.row + 1) * Sb]
            rconf = conf[e.row * Sb: (e.row + 1) * Sb]
            s = e.block_start
            e.req.tokens[s: s + Sb] = diffusion.commit_tokens(
                e.req.tokens[s: s + Sb], rid, rconf, e.n_commit, self.mask_id)

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

    def _run_refresh(self, chunk: List[Request]) -> Tuple[torch.Tensor, int]:
        """Padded Refresh: a pow2 request bucket of ``[b, max_seq_len]``
        rows; the pad rows' caches land in the scratch slot. Returns (block
        hidden [n, Sb, D], executed tokens = b·max_seq_len)."""
        n = len(chunk)
        b = _bucket(n)
        S = self.serve.max_seq_len
        tokens = np.zeros((b, S), np.int32)
        valid = np.zeros((b, S), bool)
        bstart = np.zeros((b,), np.int32)
        for j, r in enumerate(chunk):
            tokens[j] = r.tokens
            valid[j, : r.total_len] = True
            bstart[j] = r.block_start
        self._check_slots(chunk)
        out = BB.serve_refresh(self.params, self.cfg, self._dev(tokens),
                               self._dev(bstart), self.ctx,
                               token_valid=self._dev(valid))
        self.pool.write([r.slot for r in chunk]
                        + [self.pool.scratch_slot] * (b - n), out.cache)
        self.stats.padded_refresh_calls += 1
        self.stats.refresh_tokens_real += sum(r.refresh_len for r in chunk)
        self.stats.refresh_tokens_exec += b * S
        return out.block_hidden[:n], b * S

    def _run_refresh_packed(self, seg_layout) -> Tuple[torch.Tensor, int]:
        """Token-packed Refresh: one ragged stream bucketed on total tokens.
        Returns (block hidden [n, Sb, D], executed tokens)."""
        chunk = list(seg_layout.requests)
        cu_real = seg_layout.cu_seqlens
        n = len(chunk)
        rp = _bucket(n)
        t_real = seg_layout.total_tokens
        tp = self._token_bucket(t_real)
        tokens = np.zeros((tp,), np.int32)
        pos = np.zeros((tp,), np.int32)
        seg = np.full((tp,), PAD_SEG, np.int32)
        valid = np.zeros((tp,), bool)
        # padding requests point at the (invalid) tail so their gathers stay
        # in bounds; their caches land in the scratch slot
        cu = np.full((rp,), max(0, tp - 1), np.int32)
        lens = np.zeros((rp,), np.int32)
        bstart = np.zeros((rp,), np.int32)
        for j, r in enumerate(chunk):
            off = int(cu_real[j])
            ln = r.refresh_len
            assert ln == int(cu_real[j + 1]) - off, "layout/request mismatch"
            tokens[off: off + ln] = r.tokens[: r.total_len]
            pos[off: off + ln] = np.arange(ln, dtype=np.int32)
            seg[off: off + ln] = j
            valid[off: off + ln] = True
            cu[j] = off
            lens[j] = ln
            bstart[j] = r.block_start
        self._check_slots(chunk)
        out = BB.serve_refresh_packed(
            self.params, self.cfg, self._dev(tokens), self._dev(pos),
            self._dev(seg), self._dev(valid), self._dev(cu), self._dev(lens),
            self._dev(bstart), self.ctx)
        self.pool.write([r.slot for r in chunk]
                        + [self.pool.scratch_slot] * (rp - n), out.cache)
        self.stats.packed_refresh_calls += 1
        self.stats.refresh_tokens_real += t_real
        self.stats.refresh_tokens_exec += tp
        return out.block_hidden[:n], tp

    def _run_reuse_packed(self, seg_layout) -> Tuple[torch.Tensor, int]:
        """Token-packed Reuse: the active blocks as one ``[R·Sb]`` stream,
        R rounded to the token-bucket granularity (scratch slots back the
        padding segments). Returns (block hidden [n, Sb, D], rp·Sb)."""
        reqs = list(seg_layout.requests)
        n = len(reqs)
        Sb = self.serve.block_size
        rp = self._reuse_bucket(n)
        tq = rp * Sb
        btok = np.zeros((tq,), np.int32)
        bpos = np.zeros((tq,), np.int32)
        slots = [self.pool.scratch_slot] * rp
        for j, r in enumerate(reqs):
            off = int(seg_layout.cu_seqlens[j])
            btok[off: off + Sb] = r.block_tokens()
            bpos[off: off + Sb] = np.arange(r.block_start,
                                            r.block_start + Sb)
            slots[j] = r.slot
        self._check_slots(reqs)
        h = BB.serve_reuse_packed(self.params, self.cfg, self._dev(btok),
                                  self._dev(bpos), self.pool.gather(slots),
                                  self.ctx)
        self.stats.packed_reuse_calls += 1
        self.stats.reuse_tokens_real += n * Sb
        self.stats.reuse_tokens_exec += tq
        return h.reshape(rp, Sb, -1)[:n], tq

    def _run_reuse(self, reqs: List[Request]) -> Tuple[torch.Tensor, int]:
        """Padded Reuse: a pow2 request bucket whose pad rows read the
        scratch slot. Returns (block hidden [n, Sb, D], b·Sb)."""
        n = len(reqs)
        b = _bucket(n)
        Sb = self.serve.block_size
        btok = np.zeros((b, Sb), np.int32)
        bpos = np.zeros((b, Sb), np.int32)
        slots = [self.pool.scratch_slot] * b
        for j, r in enumerate(reqs):
            btok[j] = r.block_tokens()
            bpos[j] = np.arange(r.block_start, r.block_start + Sb)
            slots[j] = r.slot
        self._check_slots(reqs)
        h = BB.serve_reuse(self.params, self.cfg, self._dev(btok),
                           self._dev(bpos), self.pool.gather(slots), self.ctx)
        self.stats.padded_reuse_calls += 1
        self.stats.reuse_tokens_real += n * Sb
        self.stats.reuse_tokens_exec += b * Sb
        return h[:n], b * Sb
