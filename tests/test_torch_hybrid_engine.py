"""The hybrid family (zamba2-7b: the Mamba2 stack and the shared causal
attention block) under every serving system, as
``test_torch_scan_engine.py`` holds the ssm family: the three baselines
with the kernel flags (the shared block's padded Reuse reads its cache
through ``packed_flash_attention``, causal, with rows that see no cached
key), dllm-serve without the kernel flag, and the launcher's JSON under
sparse-dllm. Exact: ids, request
times, every EngineStats counter, the modeled clock.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import pytest

from test_torch_scan_engine import (SYSTEMS, baseline_matches,
                                    dllm_serve_without_kernels_matches,
                                    run_serve_baseline_matches)

ARCH = "zamba2-7b"


@pytest.mark.parametrize("system", SYSTEMS)
def test_baselines_match_reference_exactly(system):
    baseline_matches(ARCH, system)


def test_dllm_serve_without_kernels_matches_reference_exactly():
    dllm_serve_without_kernels_matches(ARCH)


def test_run_serve_baseline_json_matches_reference():
    run_serve_baseline_matches(ARCH, "sparse-dllm")
