"""Serving systems (paper §6.1) as ServeConfig profiles, as in
``repro.core.baselines``. The engine serves only the ``dllm-serve`` profile
so far; the other three need the request-level scheduler and the padded
path (ROADMAP Queue A)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ServeConfig


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
