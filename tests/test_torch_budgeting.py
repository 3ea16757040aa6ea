"""The offline memory profiler and the launcher's defaults against the
reference.

* ``plan_memory`` field for field, ``MemoryPlan.summary`` and
  ``size_slots(...).max_slots`` for every registered arch under every
  system of ``system_profiles``, at 24 and 80 GB, at the launcher's plan
  geometry (``max_seq_len=2048``, ``max_num_batched_tokens=4000``,
  ``max_num_logits=2048``, 12 slots).
* The slot pool the engine allocates holds ``kv_slot_bytes`` a slot.
* ``run_serve`` at both packages' keyword defaults (the profiler on, 24 GB)
  gives the same ids, counters, modeled clock, slots and plan.
* The two ``run_serve`` signatures share every default (``pipeline=True``
  included).
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses
import inspect

import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import size_slots as jsize_slots
from repro.core.baselines import system_profiles as jprofiles
from repro.core.budgeting import plan_memory as jplan_memory
from repro.launch.serve import run_serve as jrun_serve
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import budgeting as TB
from repro_torch.core.baselines import size_slots, system_profiles
from repro_torch.core.engine import Engine
from repro_torch.core.kv_pool import tree_leaves
from repro_torch.launch.serve import run_serve as trun_serve

SYSTEMS = ("fast-dllm", "dllm-cache", "sparse-dllm", "dllm-serve")
# the launcher's plan geometry over its own defaults
PLAN = dict(max_seq_len=2048, max_num_batched_tokens=4000,
            max_num_logits=2048, block_size=8, steps_per_block=8,
            max_slots=12, max_refresh_per_iter=4)
# what the reference sizes llada-8b to at its default 24 GB
LLADA_24GB = {"fast-dllm": 2, "dllm-cache": 2, "sparse-dllm": 5,
              "dllm-serve": 6}


@pytest.mark.parametrize("gb", [24, 80])
@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("arch", list_archs())
def test_plan_and_slots_match_reference(arch, system, gb):
    hbm = gb << 30
    jserve = jprofiles(JServe(**PLAN))[system]
    tserve = system_profiles(TServe(**PLAN))[system]
    want = jplan_memory(jget_config(arch), jserve, hbm)
    got = TB.plan_memory(get_config(arch), tserve, hbm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    slots = size_slots(get_config(arch), tserve, hbm).max_slots
    assert slots == jsize_slots(jget_config(arch), jserve, hbm).max_slots
    if arch == "llada-8b":
        assert slots == (LLADA_24GB[system] if gb == 24 else 12)


@pytest.mark.parametrize("arch,system", [
    ("llada-8b", "dllm-serve"), ("llada-8b", "fast-dllm"),
    ("zamba2-7b", "dllm-serve"), ("mamba2-130m", "dllm-serve")])
def test_pool_slot_bytes_are_kv_slot_bytes(arch, system):
    """The engine's cache tensors, scratch slot aside, come to
    ``kv_slot_bytes`` a slot on the reduced configs (float32)."""
    cfg = reduced(get_config(arch))
    serve = dataclasses.replace(
        system_profiles(TServe(max_num_batched_tokens=128, max_num_logits=32,
                               block_size=8, steps_per_block=8,
                               max_seq_len=64, max_slots=3,
                               pipeline=False))[system],
        use_flash_kernel=True, logit_mode="fused")
    eng = Engine(cfg, serve, clock="modeled", device="cpu")
    eng.warmup()
    leaves = tree_leaves(eng.pool.cache)
    assert all(t.shape[1] == serve.max_slots + 1 for t in leaves)
    pool_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert pool_bytes // (serve.max_slots + 1) == TB.kv_slot_bytes(cfg, serve)
    assert pool_bytes % (serve.max_slots + 1) == 0


HOST_CLOCK = {"host_plan_s", "host_fill_s", "sync_wait_s", "warmup_s",
              "wall_clock_s", "wall_tok_s", "overlapped_host_s",
              "overlap_frac"}     # the host's clock
JAX_ONLY = {"compile_counts", "compiles_warmup", "compiles_post_warmup"}
# replays per captured stage entry, the captured graphs' pool
PORT_ONLY = {"graph_replays", "graph_pool_bytes"}


@pytest.mark.parametrize("system,slots", [("dllm-serve", 6),
                                          ("fast-dllm", 2)])
def test_run_serve_defaults_match_reference(system, slots):
    want = jrun_serve("llada-8b", system, "burst", 4.0, 3)
    got = trun_serve("llada-8b", system, "burst", 4.0, 3, device="cpu")
    assert set(got) == set(want) | PORT_ONLY
    assert got["max_slots"] == slots and got["n_finished"] == 3
    assert got["plan_slots_phys"] == slots and got["plan_slot_bytes"] > 0
    assert got["pipeline"] is True and got["dispatched_ahead"] > 0
    for k in sorted(set(want) - HOST_CLOCK - JAX_ONLY):
        assert got[k] == want[k], k


def test_run_serve_signatures_share_defaults():
    """Every parameter of both launchers has the reference's default, the
    pipelined loop and streaming included."""
    jsig = inspect.signature(jrun_serve).parameters
    tsig = inspect.signature(trun_serve).parameters
    shared = set(jsig) & set(tsig)
    assert {"size_by_profiler", "hbm_gb", "kernels", "clock", "pipeline",
            "stream"} <= shared
    differ = {n for n in shared if jsig[n].default != tsig[n].default}
    assert differ == set(), differ
    assert tsig["pipeline"].default is True


def test_measure_logit_peak_refuses_the_cpu():
    cfg = reduced(get_config("llada-8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.measure_logit_peak(cfg, TServe(), 8, device="cpu")
