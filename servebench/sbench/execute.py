"""One run of one cell: set-up, the measured window, the check, the
metrics, and the result line.

The end-to-end metrics come from a run with tracing off; ``trace=True`` is
a run of its own under ``torch.profiler`` whose per-layer metrics come
from the trace, the engine's ``iter_log`` and counters, and the stamps.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import List

import torch

from sbench import check, session, spec, trace as tracing, window
from sbench.peaks import peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float,
            log=lambda *a: print(*a, file=sys.stderr)) -> dict:
    sess = session.Session(cell, seed, device, t_start, log)
    w = sess.window(seed, seconds, trace=trace)
    sess.close()
    gc.collect()
    run = w.run
    log(f"servebench: {len(run.events)} events, {len(run.rows)} "
        f"iterations in the window")
    if w.prof is not None:
        t0 = time.perf_counter()
        run.trace = tracing.collect(w.prof, seconds)
        w.prof = None
        log(f"servebench: trace read in {time.perf_counter() - t0} s, "
            f"{len(run.trace.device)} device and {len(run.trace.host)} "
            f"host intervals")
    if device.type == "cuda":
        run.peak = peaks(sess.kind)
    verdict = verify(cell, run, sess.params, seed, log)
    metrics = spec.read_metrics(cell, run, trace)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": sess.kind, "count": 1,
           "memory_peak_bytes": w.memory_peak_bytes}
    out = {"correct": verdict["correct"],
           "attempted": sum(1 for r in run.reqs if r.due < seconds),
           "failed": w.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = tracing.busy_s(run.trace)
        dev["window_s"] = float(seconds)
        out["breakdown"] = tracing.breakdown(run.trace)
    out["checks"] = verdict["checks"]
    return out


def verify(cell: spec.Cell, run: session.Run, params: dict, seed: int, log,
           control: bool = False) -> dict:
    """``correct`` and the numbers compared, each beside its limit; with
    ``control`` also the control's numbers and its verdict by the same
    :func:`check.decide` (never in a benchmark run)."""
    config = run.config
    lim = config["checks"]
    geom = check.geometry(config)
    cs = window.commits(run.events, run.reqs, geom["block_size"],
                        geom["steps_per_block"], run.mask_id)
    done = check.finished(run.reqs, run.events, run.mask_id,
                          geom["block_size"])
    picked = check.sample(done, seed, lim["sample_tokens"],
                          lim["sample_requests"])
    ref = spec.reference(config["reference"], cell.root)
    j = check.judge(picked, run.events, cs, ref, geom, run.mask_id)
    t0 = time.perf_counter()
    got = check.readings(ref, params, config["model"], geom, j, run.mask_id,
                         control=control)
    ref_s = time.perf_counter() - t0
    judged = int(j.committed.sum())

    def checks(logit_gap, order, misses):
        return {"logit_gap": [logit_gap, lim["logit_gap"]],
                "order_regret": [order["regret"], lim["order_regret"]],
                "schedule_misses": [misses, 0],
                "judged_tokens": [judged, lim["judged_tokens"]]}
    out_checks = checks(got["logit_gap"], got["order"],
                        window.schedule_misses(cs))
    log(f"servebench: reference over {len(picked)} of {len(done)} finished "
        f"requests, {judged} tokens, {len(j.step)} rows, {ref_s} s")
    out = {"correct": check.decide(out_checks), "checks": out_checks,
           "reference_s": ref_s, "rids": j.rids, "finished": len(done),
           "order": got["order"]}
    if control:
        # the control commits the schedule's count by construction
        out["control_checks"] = checks(got["control_logit_gap"],
                                       got["control_order"], 0)
        out["control_order"] = got["control_order"]
        out["control_correct"] = check.decide(out["control_checks"])
    return out


def check_lines(checks: dict) -> List[str]:
    """Each number compared beside its limit, one a line."""
    return [f"check {name} {value} "
            f"{'>=' if name in check.AT_LEAST else '<='} {limit}"
            for name, (value, limit) in checks.items()]
