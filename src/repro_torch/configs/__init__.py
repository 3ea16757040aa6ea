"""Architecture registry: ``--arch <id>`` resolves here.

Only the archs the port serves are listed; the others join with the slices
that port their model families (ROADMAP Queue A).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ServeConfig, reduced
from repro_torch.configs.llada_8b import CONFIG as _llada_8b

ARCHS = {
    "llada-8b": _llada_8b,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = ["ModelConfig", "ServeConfig", "ARCHS", "get_config", "list_archs",
           "reduced"]
