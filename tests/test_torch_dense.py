"""The four dense archs the port registers beside llada-8b (qwen2.5-14b,
gemma2-27b, gemma-2b, qwen2-72b): reduced float32 configs served by the JAX
engine and by the port's engine on the CPU (the kernels' plain versions)
from the same weights, under dllm-serve with the kernel flags and under
sparse-dllm (the padded path) with them. Exact, as in
``test_torch_engine.py``: every committed id, request time, EngineStats
counter and the modeled clock.

Beside each arch's default ``reduced`` config, the shapes that default
hides, as overrides passed to both packages' ``reduced``: GQA groups of
five (qwen2.5-14b's 40 / 8 heads), gemma2-27b's groups of two (with its
window of 8 on alternate layers and both softcaps active), and gemma-2b's
head_dim 256 on its one KV head.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import pytest

from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import system_profiles as jprofiles
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.baselines import system_profiles as tprofiles
from test_torch_engine import BASE, SERVE, _serve_both

CASES = [
    ("qwen2.5-14b", {}), ("gemma2-27b", {}), ("gemma-2b", {}),
    ("qwen2-72b", {}),
    ("qwen2.5-14b", dict(n_heads=10, n_kv_heads=2)),
    ("gemma2-27b", dict(n_kv_heads=2)),
    ("gemma-2b", dict(head_dim=256)),
]


def _ids(case):
    arch, over = case
    return arch + "".join(f"-{k}={v}" for k, v in over.items())


def _kernels(serve):
    return dataclasses.replace(serve, use_flash_kernel=True,
                               logit_mode="fused")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_dense_dllm_serve_matches_reference_exactly(case):
    arch, over = case
    ts = _serve_both(_kernels(jprofiles(JServe(**SERVE))["dllm-serve"]),
                     _kernels(tprofiles(TServe(**SERVE))["dllm-serve"]),
                     arch=arch, **over)
    assert ts.packed_refresh_calls > 0 and ts.padded_refresh_calls == 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_dense_sparse_dllm_matches_reference_exactly(case):
    arch, over = case
    ts = _serve_both(_kernels(jprofiles(JServe(**BASE))["sparse-dllm"]),
                     _kernels(tprofiles(TServe(**BASE))["sparse-dllm"]),
                     check_deferred=False, arch=arch, **over)
    assert ts.padded_refresh_calls > 0 and ts.padded_reuse_calls > 0
