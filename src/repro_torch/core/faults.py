"""Deterministic fault-injection harness (chaos testing for the engine), a
copy of ``repro.core.faults`` (pure host code).

A :class:`FaultPlan` is a *seeded, finite schedule* of injected faults that
the engine consumes at well-defined sites inside :meth:`Engine.step`:

- ``dispatch`` — a stage call (refresh / reuse / decode) raises
  :class:`FaultError`; the engine retries with exponential backoff on the
  modeled clock, up to ``ServeConfig.fault_retries`` attempts.
- ``alloc``    — the next ``count`` slot allocations fail transiently; the
  scheduler defers admission for the iteration (backpressure, no raise).
- ``mem``      — a memory-pressure event steals ``count`` free slots for
  ``duration`` iterations (shrinking effective capacity); if the waiting
  queue starves past the preemption threshold meanwhile, the normal
  preempt-to-reclaim path fires.
- ``slow``     — the iteration is delayed by ``delay_s`` (modeled clock:
  charged to vtime; wall clock: slept), perturbing arrival interleaving.

Everything is driven by an explicit event list or :meth:`FaultPlan.seeded`,
so a chaos run is exactly reproducible: the test suite asserts end-state
equivalence against the fault-free run (same token ids for every non-shed
request, zero leaked slots, ``submitted == finished + shed + rejected``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

KINDS = ("dispatch", "alloc", "mem", "slow")


class FaultError(RuntimeError):
    """An injected (or real) stage-dispatch failure."""


@dataclass(frozen=True)
class FaultEvent:
    kind: str               # one of KINDS
    at_iter: int            # engine iteration the event activates on
    count: int = 1          # dispatch: failures to inject; alloc: failed
                            # allocations; mem: slots stolen
    duration: int = 1       # mem: iterations the steal lasts
    delay_s: float = 0.0    # slow: added iteration latency (seconds)
    stage: str = "any"      # dispatch: restrict to refresh/reuse/decode

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """Consumable fault schedule. One plan drives one engine run."""

    def __init__(self, events: List[FaultEvent]):
        self.events = sorted(events, key=lambda e: e.at_iter)
        self._cursor = 0
        self._iter = -1
        # live tokens
        self._dispatch: List[FaultEvent] = []   # pending dispatch failures
        self._alloc = 0                          # pending alloc failures
        self._mem: List[Tuple[int, int]] = []    # (slots_stolen, expires_iter)
        self._slow = 0.0                         # pending delay for this iter
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}

    @classmethod
    def seeded(cls, seed: int, horizon: int = 200, n_events: int = 6,
               max_retries: int = 3) -> "FaultPlan":
        """Random-but-reproducible schedule. Dispatch bursts stay strictly
        below ``max_retries`` so a seeded chaos run degrades (retries,
        deferrals, delays) but never escalates to a permanent
        :class:`FaultError` — permanence is a deliberate, hand-built case."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = KINDS[int(rng.integers(len(KINDS)))]
            at = int(rng.integers(1, horizon))
            if kind == "dispatch":
                events.append(FaultEvent(
                    kind, at, count=int(rng.integers(1, max_retries)),
                    stage=("any", "refresh", "reuse",
                           "decode")[int(rng.integers(4))]))
            elif kind == "alloc":
                events.append(FaultEvent(kind, at,
                                         count=int(rng.integers(1, 4))))
            elif kind == "mem":
                events.append(FaultEvent(kind, at,
                                         count=int(rng.integers(1, 3)),
                                         duration=int(rng.integers(2, 8))))
            else:
                events.append(FaultEvent(
                    kind, at, delay_s=float(rng.uniform(0.01, 0.3))))
        return cls(events)

    # -- per-iteration protocol -------------------------------------------
    def begin_iteration(self, it: int) -> None:
        """Activate events scheduled at or before ``it``; expire mem steals."""
        self._iter = it
        self._slow = 0.0
        while self._cursor < len(self.events) and \
                self.events[self._cursor].at_iter <= it:
            ev = self.events[self._cursor]
            self._cursor += 1
            if ev.kind == "dispatch":
                self._dispatch.extend([ev] * ev.count)
            elif ev.kind == "alloc":
                self._alloc += ev.count
            elif ev.kind == "mem":
                self._mem.append((ev.count, it + ev.duration))
                self.injected["mem"] += 1
            else:
                self._slow += ev.delay_s
        self._mem = [(n, exp) for (n, exp) in self._mem if exp > it]

    def take_dispatch_fault(self, stage: str) -> bool:
        """Consume one pending dispatch failure for ``stage`` (or 'any')."""
        for i, ev in enumerate(self._dispatch):
            if ev.stage in ("any", stage):
                del self._dispatch[i]
                self.injected["dispatch"] += 1
                return True
        return False

    def take_alloc_fault(self) -> bool:
        """Consume one pending transient slot-allocation failure."""
        if self._alloc > 0:
            self._alloc -= 1
            self.injected["alloc"] += 1
            return True
        return False

    def stolen_slots(self) -> int:
        """Free slots currently held hostage by active mem-pressure events."""
        return sum(n for (n, _) in self._mem)

    def take_slow_delay(self) -> float:
        d, self._slow = self._slow, 0.0
        if d:
            self.injected["slow"] += 1
        return d

    def blocking(self) -> bool:
        """True while the plan can still suppress progress: pending alloc
        tokens, live mem steals, or any not-yet-activated event. The engine
        uses this to keep spinning (iteration count advances the schedule)
        instead of declaring a stall."""
        return (self._alloc > 0 or bool(self._mem)
                or self._cursor < len(self.events))
