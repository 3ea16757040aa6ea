"""Retrace sentinel: the zero-post-warmup build budget, as
``repro.analysis.retrace``.

Every (stage, bucket) entry of the serving path is built once by
``core.graphs.StageGraphs`` (captured as a CUDA graph on the card, run
eagerly elsewhere) and counted per stage in ``compile_counts``. The
Engine snapshots the counts in ``EngineStats``:

* ``compile_counts``   — per-stage totals,
* ``compiles_warmup``  — the count at the end of ``Engine.warmup()``,
* ``compiles_post_warmup`` — everything after: an entry the warmup did
  not build and the run needed. The budget holds it at **zero**: a
  graphed serve that builds after warmup captures on the serving path.

``check_engine(engine)`` is the post-run audit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class RetraceReport:
    compile_counts: Dict[str, int] = field(default_factory=dict)
    compiles_warmup: int = 0
    compiles_post_warmup: int = 0
    budget: int = 0
    violations: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"ok": self.ok, "compile_counts": self.compile_counts,
                "compiles_warmup": self.compiles_warmup,
                "compiles_post_warmup": self.compiles_post_warmup,
                "budget": self.budget, "violations": self.violations}


def check_engine(engine, budget: int = 0) -> RetraceReport:
    """Audit an Engine's build counters after a run.

    ``budget`` is the number of post-warmup builds tolerated (0: the
    warmup builds every bucket ``engine.stage_keys`` names)."""
    stats = engine.stats
    report = RetraceReport(
        compile_counts=dict(stats.compile_counts),
        compiles_warmup=stats.compiles_warmup,
        compiles_post_warmup=stats.compiles_post_warmup,
        budget=budget)
    if stats.compiles_warmup == 0 and sum(stats.compile_counts.values()):
        report.violations.append(
            "warmup snapshot missing: Engine.warmup() was never called, so "
            "every build is billed post-warmup")
    if report.compiles_post_warmup > budget:
        report.violations.append(
            f"{report.compiles_post_warmup} post-warmup build(s) exceed the "
            f"budget of {budget}: {report.compile_counts} (an unwarmed "
            "bucket: a capture on the serving path)")
    return report
