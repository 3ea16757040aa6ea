"""Serving systems (paper §6.1) and the §6.6 ablation as ServeConfig
profiles, as in ``repro.core.baselines``. Every system runs through the same
Engine, so differences come only from the policies the paper varies:
scheduler granularity, KV selection, refresh cadence, logit handling, and
padded versus token-packed execution (``varlen_pack``). Slot capacity per
system comes from the offline profiler (:func:`size_slots`): systems that
reserve a monolithic logit buffer or keep dense caches fit fewer concurrent
requests in the same memory."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.budgeting import plan_memory


def system_profiles(base: ServeConfig) -> Dict[str, ServeConfig]:
    r = dataclasses.replace
    return {
        "fast-dllm": r(base, scheduler="request", selection="none",
                       retention_ratio=1.0, refresh_interval=0,
                       logit_mode="monolithic"),
        "dllm-cache": r(base, scheduler="request", selection="none",
                        retention_ratio=1.0, refresh_interval=7,
                        logit_mode="monolithic"),
        "sparse-dllm": r(base, scheduler="request", selection="uniform",
                         retention_ratio=0.5, refresh_interval=8,
                         logit_mode="monolithic"),
        "dllm-serve": r(base, scheduler="phase", selection="head",
                        retention_ratio=0.5, refresh_interval=8,
                        logit_mode="chunked", varlen_pack=True),
    }


def ablation_profiles(base: ServeConfig) -> Dict[str, ServeConfig]:
    """§6.6 cumulative toggles on top of the Sparse-dLLM baseline."""
    r = dataclasses.replace
    baseline = r(base, scheduler="request", selection="uniform",
                 retention_ratio=0.5, refresh_interval=8,
                 logit_mode="monolithic")
    # custom engine: head-centric packed KV + varlen flattening (§6.6)
    engine = r(baseline, selection="head", varlen_pack=True)
    sched = r(engine, scheduler="phase")                  # + smart scheduler
    budget = r(sched, logit_mode="chunked")               # + logit budgeting
    return {"baseline": baseline, "+engine": engine,
            "+scheduler": sched, "+budgeting": budget}


def size_slots(cfg: ModelConfig, serve: ServeConfig, hbm_bytes: int,
               floor: int = 1, share_factor: float = 1.0) -> ServeConfig:
    """Clamp ``max_slots`` to what the profiler says fits ``hbm_bytes`` (at
    least ``floor``).

    ``share_factor`` (the workload's measured prefix-sharing ratio) reaches
    the plan so its logical capacity is reported, but sizing clamps to the
    plan's PHYSICAL capacity: the pool reserves physical backing per
    logical slot, so allocating the logical count would overshoot the
    budget. int8 ``kv_quant`` genuinely shrinks ``slot_bytes``, so the
    physical capacity itself grows."""
    plan = plan_memory(cfg, serve, hbm_bytes, share_factor=share_factor)
    fit = plan.phys_slots or plan.max_slots
    return dataclasses.replace(
        serve, max_slots=max(floor, min(serve.max_slots, fit)))
