"""The ssm family (mamba2-130m) under every serving system; the hybrid's
cases run on these helpers in ``test_torch_hybrid_engine.py``. The JAX
engine and the port's engine serve the same requests on the same weights (reduced, float32) on the modeled clock with the synchronous loop;
the port runs on the CPU, i.e. on its kernels' plain versions. The three
baselines (request-level scheduler, padded stages) run with the kernel
flags (``--kernels``); dllm-serve runs with its profile's own flags,
``use_flash_kernel=False`` (the packed path's plain fallbacks:
``varlen_ssd_scan``, the segment-masked attention, the split Reuse).

Exact: every committed id, request time, EngineStats counter and the
modeled clock (``test_torch_engine._serve_both``), and the launcher's JSON
for one baseline of each family.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import pytest

from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import system_profiles as jprofiles
from repro.launch.serve import run_serve as jrun_serve
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.baselines import system_profiles as tprofiles
from repro_torch.kernels import build
from repro_torch.launch.serve import run_serve as trun_serve
from test_torch_engine import BASE, HOST_TIMES, JAX_ONLY, PORT_ONLY, \
    _serve_both

ARCH = "mamba2-130m"
SKIP = HOST_TIMES | JAX_ONLY | {"warmup_s", "wall_clock_s", "wall_tok_s",
                               "overlap_frac", "compiles_post_warmup"}


def _profile(system, kernels):
    def serve(cls, profiles):
        s = profiles(cls(**BASE))[system]
        if kernels:
            s = dataclasses.replace(s, use_flash_kernel=True,
                                    logit_mode="fused")
        return s
    return serve(JServe, jprofiles), serve(TServe, tprofiles)


def baseline_matches(arch, system):
    build.reset_counters()
    ts = _serve_both(*_profile(system, True), check_deferred=False,
                     arch=arch)
    assert ts.padded_refresh_calls > 0 and ts.padded_reuse_calls > 0
    assert ts.packed_refresh_calls == 0
    # the padded scan is the reference's jnp ssd_scan, never the kernel;
    # the hybrid's shared block reads its cache through row 6
    assert build.COUNTERS["ssm_segment_scan"].plain_calls == 0
    pfa = build.COUNTERS["packed_flash_attention"].plain_calls
    assert (pfa > 0) == (arch == "zamba2-7b"), pfa


def dllm_serve_without_kernels_matches(arch):
    """dllm-serve with its profile's flags (no kernel flag): the packed
    stages run their plain fallbacks, and no kernel's plain version runs
    in their place."""
    build.reset_counters()
    ts = _serve_both(*_profile("dllm-serve", None), check_deferred=False,
                     arch=arch)
    assert ts.packed_refresh_calls > 0 and ts.padded_refresh_calls == 0
    for name in ("ssm_segment_scan", "flash_varlen", "flash_varlen_cross",
                 "head_score_varlen", "fused_logit_argmax"):
        assert build.COUNTERS[name].plain_calls == 0, name


def run_serve_baseline_matches(arch, system):
    kw = dict(use_reduced=True, seed=2, kernels=True, clock="modeled",
              size_by_profiler=False, pipeline=False, max_seq_len=96,
              max_num_batched_tokens=256, max_slots=4, max_num_logits=32)
    want = jrun_serve(arch, system, "burst", 4.0, 3, **kw)
    got = trun_serve(arch, system, "burst", 4.0, 3, device="cpu", **kw)
    assert got["n_finished"] == 3 and got["padded_reuse_calls"] > 0
    assert set(got) == set(want) | PORT_ONLY
    for k in sorted(set(want) - SKIP):
        assert got[k] == want[k], k


SYSTEMS = ["fast-dllm", "dllm-cache", "sparse-dllm"]


@pytest.mark.parametrize("system", SYSTEMS)
def test_baselines_match_reference_exactly(system):
    baseline_matches(ARCH, system)


def test_dllm_serve_without_kernels_matches_reference_exactly():
    dllm_serve_without_kernels_matches(ARCH)


def test_run_serve_baseline_json_matches_reference():
    run_serve_baseline_matches(ARCH, "dllm-cache")
