"""The paper's Phase-Multiplexed Greedy Scheduler (§4.4) and the baselines'
request-level static batching, copied from ``repro.core.scheduler``.

Invariant: an iteration never carries more *query tokens* than
``max_num_batched_tokens``. Query tokens are the scheduling currency because
per-iteration activation workspace scales with them, while KV sits in the
pre-allocated pool and logits are bounded separately by ``max_num_logits``.

``plan()`` also rejects never-admittable waiters, sheds expired ones, bounds
the waiting queue under ``queue_cap``, and with ``preempt_starvation_s``
preempts the youngest Reuse-phase resident for a starved head waiter. The
fault hooks are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ServeConfig
from repro_torch.core.budgeting import admission_block_reason
from repro_torch.core.request import Outcome, Phase, Request, State


@dataclass(frozen=True)
class StageSegments:
    """One packed sub-stream: requests in stream order plus the exclusive
    prefix offsets of their token spans (``cu_seqlens[-1]`` is the true,
    pre-bucketing stream length)."""
    requests: Tuple[Request, ...]
    cu_seqlens: np.ndarray          # [n + 1] int32

    @property
    def total_tokens(self) -> int:
        return int(self.cu_seqlens[-1])

    @property
    def token_counts(self) -> List[int]:
        return [int(d) for d in np.diff(self.cu_seqlens)]


@dataclass(frozen=True)
class PackedIterationLayout:
    """Whole-iteration packed layout: the Refresh chunks, the Reuse stream of
    ``block_size`` segments, the logit row count, and the whole Refresh set
    as one fused stream (what the engine dispatches)."""
    refresh_chunks: Tuple[StageSegments, ...]
    reuse: Optional[StageSegments]
    logit_tokens: int
    refresh_fused: Optional[StageSegments] = None

    @property
    def refresh_total_tokens(self) -> int:
        return sum(c.total_tokens for c in self.refresh_chunks)

    @property
    def reuse_total_tokens(self) -> int:
        return self.reuse.total_tokens if self.reuse else 0


@dataclass
class IterationPlan:
    refresh: List[Request] = field(default_factory=list)
    reuse: List[Request] = field(default_factory=list)
    deferred: List[Request] = field(default_factory=list)
    admitted: List[Request] = field(default_factory=list)
    rejected: List[Request] = field(default_factory=list)
    shed: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)   # requeued, live
    recomputed_tokens: int = 0

    @property
    def has_exec(self) -> bool:
        """True when the iteration executes device work. Every plan field is
        a function of request lengths, phases and config, never of token
        values."""
        return bool(self.refresh or self.reuse)

    @property
    def query_tokens(self) -> int:
        return sum(r.query_tokens for r in self.refresh + self.reuse)

    @property
    def n_logit_tokens(self) -> int:
        return sum(r.cfg.block_size for r in self.refresh + self.reuse)

    @property
    def refresh_token_counts(self) -> List[int]:
        return [r.refresh_len for r in self.refresh]

    @property
    def refresh_total_tokens(self) -> int:
        return sum(self.refresh_token_counts)

    def refresh_cu_seqlens(self) -> np.ndarray:
        """[n_refresh + 1] int32 exclusive prefix offsets of the plan-level
        packed Refresh stream."""
        return np.concatenate(
            [[0], np.cumsum(self.refresh_token_counts)]).astype(np.int32)

    def packed_layout(self, max_refresh_per_iter: int = 0
                      ) -> PackedIterationLayout:
        """Build the whole-iteration packed layout the engine executes."""
        cap = max(1, max_refresh_per_iter) if max_refresh_per_iter \
            else max(1, len(self.refresh))
        cu = self.refresh_cu_seqlens()
        chunks = []
        for i in range(0, len(self.refresh), cap):
            reqs = tuple(self.refresh[i: i + cap])
            chunks.append(StageSegments(
                reqs, (cu[i: i + len(reqs) + 1] - cu[i]).astype(np.int32)))
        reuse = None
        if self.reuse:
            Sb = self.reuse[0].cfg.block_size
            reuse = StageSegments(
                tuple(self.reuse),
                (np.arange(len(self.reuse) + 1) * Sb).astype(np.int32))
        fused = StageSegments(tuple(self.refresh), cu) if self.refresh \
            else None
        return PackedIterationLayout(tuple(chunks), reuse,
                                     self.n_logit_tokens, fused)


class PhaseMultiplexedScheduler:
    """Step-granular token packing with greedy FCFS admission.

    Each iteration: (1) running requests contribute their phase-dependent
    query cost (Refresh: L_total, Reuse: L_block) in FCFS order up to the
    budget — Refresh steps that don't fit are deferred, not dropped;
    (2) waiting requests are admitted into free slots while their initial
    Refresh cost still fits.
    """

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self._free_slots = list(range(cfg.max_slots))[::-1]
        self.pool = None            # KVPool (take/free generation ledger)

    # -- queue ops ----------------------------------------------------------
    def submit(self, req: Request) -> List[Request]:
        """Enqueue ``req``; returns the requests the bounded-queue policy
        dropped (terminal, Outcome set)."""
        cap = self.cfg.queue_cap
        if cap and len(self.waiting) >= cap:
            if self.cfg.queue_policy == "evict":
                victim = self.waiting.pop(0)
                self._terminal(victim, State.SHED, Outcome.SHED_QUEUE,
                               f"evicted: queue_cap={cap} reached")
                self.waiting.append(req)
                return [victim]
            self._terminal(req, State.REJECTED, Outcome.REJECTED_QUEUE_FULL,
                           f"rejected: queue_cap={cap} reached")
            return [req]
        self.waiting.append(req)
        return []

    def finish(self, req: Request) -> None:
        self.running.remove(req)
        self._release_slot(req)

    def _release_slot(self, req: Request) -> None:
        if req.slot is not None:
            if self.pool is not None:
                self.pool.free([req.slot])
            self._free_slots.append(req.slot)
        req.slot = None
        req.slot_gen = None

    def _claim_slot(self, req: Request) -> None:
        slot = self._free_slots.pop()
        req.slot = slot
        req.slot_gen = self.pool.take(slot) if self.pool is not None else 0

    @staticmethod
    def _terminal(req: Request, state: State, outcome: Outcome,
                  error: Optional[str] = None) -> None:
        req.state = state
        req.outcome = outcome
        req.error = error

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- robustness sweeps ---------------------------------------------------
    def _shed_and_reject(self, now: float, plan: IterationPlan) -> None:
        """Whole-queue sweep: reject never-admittable requests, shed expired
        ones."""
        keep = []
        for r in self.waiting:
            reason = admission_block_reason(self.cfg, r)
            if reason is not None:
                self._terminal(r, State.REJECTED,
                               Outcome.REJECTED_OVERSIZED, reason)
                plan.rejected.append(r)
            elif r.deadline <= now:
                self._terminal(r, State.SHED, Outcome.SHED_DEADLINE)
                plan.shed.append(r)
            else:
                keep.append(r)
        self.waiting = keep

    def _maybe_preempt(self, now: float, plan: IterationPlan) -> None:
        """When the head waiter has starved past ``preempt_starvation_s``
        with no free slot, the youngest Reuse-phase resident rolls its block
        back, frees its slot and requeues at the TAIL of the queue."""
        thr = self.cfg.preempt_starvation_s
        if not thr or not self.waiting:
            return
        head = self.waiting[0]
        if head.arrival > now or now - head.arrival < thr:
            return
        if self._free_slots:
            return                      # a slot is free; admission will run
        for victim in reversed(self.running):
            if victim.phase is not Phase.REUSE or \
                    victim.n_preempted >= self.cfg.max_preemptions:
                continue
            self.running.remove(victim)
            self._release_slot(victim)
            plan.recomputed_tokens += victim.rollback_block()
            victim.n_preempted += 1
            victim.state = State.WAITING
            self.waiting.append(victim)
            plan.preempted.append(victim)
            return

    # -- planning -------------------------------------------------------------
    def plan(self, now: float) -> IterationPlan:
        budget = self.cfg.max_num_batched_tokens
        plan = IterationPlan()
        refresh_slots = self.cfg.refresh_slots

        self._shed_and_reject(now, plan)
        self._maybe_preempt(now, plan)

        # 1) running requests, FCFS
        for r in self.running:
            cost = r.query_tokens
            if r.phase == Phase.REFRESH:
                if cost <= budget and len(plan.refresh) < refresh_slots:
                    plan.refresh.append(r)
                    budget -= cost
                else:
                    plan.deferred.append(r)
            else:
                if cost <= budget:
                    plan.reuse.append(r)
                    budget -= cost
                else:
                    plan.deferred.append(r)

        # 2) greedy FCFS admission into released headroom
        while (self.waiting and self._free_slots
               and len(plan.refresh) < refresh_slots):
            cand = self.waiting[0]
            if cand.arrival > now:
                break
            cost = cand.refresh_len  # first step is a Refresh
            if cost > budget:
                break
            self.waiting.pop(0)
            self._claim_slot(cand)
            cand.state = State.RUNNING
            cand.t_admitted = now
            self.running.append(cand)
            plan.refresh.append(cand)
            plan.admitted.append(cand)
            budget -= cost

        return plan


class RequestLevelScheduler(PhaseMultiplexedScheduler):
    """§3.1 baseline: STATIC request-granular batching (paper Table 1).

    Fast-dLLM / dLLM-Cache / Sparse-dLLM batch statically: a batch is
    formed, runs to completion, and only then is the next batch admitted.
    Every resident request is charged its worst case (Refresh cost =
    L_total) for its whole lifetime. No preemption: the baseline's batches
    run to completion by definition.
    """

    def plan(self, now: float) -> IterationPlan:
        plan = IterationPlan()
        budget = self.cfg.max_num_batched_tokens
        self._shed_and_reject(now, plan)

        # conservative: every running request is charged its worst case
        for r in self.running:
            budget -= r.refresh_len
            (plan.refresh if r.phase == Phase.REFRESH else plan.reuse).append(r)

        # static batching: admit only when the previous batch fully drained
        # (the engine executes oversized refresh sets in serial chunks)
        drained = not self.running
        while drained and self.waiting and self._free_slots:
            cand = self.waiting[0]
            if cand.arrival > now or cand.refresh_len > budget:
                break
            self.waiting.pop(0)
            self._claim_slot(cand)
            cand.state = State.RUNNING
            cand.t_admitted = now
            self.running.append(cand)
            plan.refresh.append(cand)
            plan.admitted.append(cand)
            budget -= cand.refresh_len
        return plan


def make_scheduler(cfg: ServeConfig) -> PhaseMultiplexedScheduler:
    if cfg.scheduler == "phase":
        return PhaseMultiplexedScheduler(cfg)
    if cfg.scheduler == "request":
        return RequestLevelScheduler(cfg)
    raise ValueError(cfg.scheduler)
