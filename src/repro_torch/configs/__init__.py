"""Architecture registry: ``--arch <id>`` resolves here.

Every arch of the reference is listed, the modality-frontend archs
(internvl2-76b, musicgen-medium) included. qwen2-72b (~135 GiB of
bfloat16 weights), internvl2-76b (~141 GB), phi3.5-moe (~84 GB) and
qwen3-moe (~470 GB) resolve and serve reduced configs; at full depth they
do not fit one 80 GB card.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ServeConfig, reduced
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2_27b
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.internvl2_76b import CONFIG as _internvl2_76b
from repro_torch.configs.llada_8b import CONFIG as _llada_8b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen_medium
from repro_torch.configs.phi35_moe import CONFIG as _phi35_moe
from repro_torch.configs.qwen25_14b import CONFIG as _qwen25_14b
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b
from repro_torch.configs.qwen3_moe_235b import CONFIG as _qwen3_moe
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2_7b

ARCHS = {
    "gemma-2b": _gemma_2b,
    "gemma2-27b": _gemma2_27b,
    "internvl2-76b": _internvl2_76b,
    "llada-8b": _llada_8b,
    "mamba2-130m": _mamba2_130m,
    "musicgen-medium": _musicgen_medium,
    "phi3.5-moe-42b-a6.6b": _phi35_moe,
    "qwen2-72b": _qwen2_72b,
    "qwen2.5-14b": _qwen25_14b,
    "qwen3-moe-235b-a22b": _qwen3_moe,
    "zamba2-7b": _zamba2_7b,
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
