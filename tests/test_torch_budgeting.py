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
* The port's device bill beside the plan (``bill_device``) with a graph
  pool fed in, and ``fit_to_budget``'s one re-size and its refusal, on
  stand-in engines.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses
import inspect

import pytest
import torch

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
from repro_torch.launch.serve import fit_to_budget
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
# replays per captured stage entry, the captured graphs' pool, the bill
PORT_ONLY = {"graph_replays", "graph_pool_bytes", "device_bill"}


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


def _llada_plan(hbm):
    serve = dataclasses.replace(system_profiles(TServe(**PLAN))["dllm-serve"],
                                max_slots=64)
    return serve, TB.plan_memory(get_config("llada-8b"), serve, hbm)


def test_device_bill_adds_the_unbilled_bytes():
    """The bill beside the plan, with a slot size and a graph pool fed in:
    the engine's pool (its slots and the scratch slot, at the serving
    geometry) in place of the plan's; a graph pool up to the activation
    reservation costs nothing more, one beyond it its excess; staging
    adds; a measured logit peak replaces the plan's logit term;
    ``slots_over`` pays the excess in the engine's slots."""
    hbm = 24 << 30
    _, plan = _llada_plan(hbm)
    budget = hbm - int(hbm * TB.GUARD_BAND)
    # a slot at S = 256 against the plan's 2,048
    slot, n = plan.slot_bytes // 8, plan.max_slots
    bill = TB.bill_device(plan, hbm, n, slot)
    assert bill.budget_bytes == budget and bill.fits
    assert bill.kv_pool_bytes == (n + 1) * slot
    assert bill.plan_kv_pool_bytes == n * plan.slot_bytes
    assert bill.total_bytes == plan.weights_bytes + plan.activation_bytes \
        + (n + 1) * slot
    slack = budget - bill.total_bytes
    assert slack > 0
    act = plan.activation_bytes
    assert TB.bill_device(plan, hbm, n, slot, graph_pool_bytes=act) \
        .total_bytes == bill.total_bytes
    over = TB.bill_device(plan, hbm, n, slot,
                          graph_pool_bytes=act + slack + 1)
    assert not over.fits and over.excess_bytes == 1 and over.slots_over == 1
    big = TB.bill_device(plan, hbm, n, slot,
                         graph_pool_bytes=act + slack + 3 * slot,
                         staging_bytes=5)
    assert big.excess_bytes == 3 * slot + 5
    assert big.slots_over == 4
    assert TB.bill_device(plan, hbm, big.slots - big.slots_over, slot,
                          graph_pool_bytes=big.graph_pool_bytes,
                          staging_bytes=5).fits
    peak = TB.bill_device(plan, hbm, n, slot,
                          logit_peak=plan.logit_bytes + 7)
    assert peak.activation_bytes == act + 7
    assert peak.as_dict()["excess_bytes"] == max(0, 7 - slack)


class _StubEngine:
    """What ``fit_to_budget`` reads of an engine: a slot size and the
    pool's rows (every slot and the scratch slot, as off a mesh), a graph
    pool (fed in, a function of the slots) and the staging bytes, on the
    CPU."""

    def __init__(self, serve, pool_of, slot):
        self.serve, self.params = serve, object()
        self.device = torch.device("cpu")
        self.pool = type("P", (), dict(slot_bytes=lambda _: slot,
                                       rows=serve.max_slots + 1))()
        self.graphs = type("G", (), dict(
            capture=False, pool_bytes=lambda _: pool_of(serve.max_slots),
            staging_bytes=lambda _: 0))()


def test_fit_to_budget_resizes_once_then_refuses():
    """A serve whose fed graph pool overruns the budget by just over two
    slots is re-sized to three slots fewer, on the first engine's weights;
    one whose pool grows past anything slots can pay is refused, with
    every figure in the message."""
    hbm = 24 << 30
    serve, plan = _llada_plan(hbm)
    serve = dataclasses.replace(serve, max_slots=plan.max_slots)
    slot = plan.slot_bytes // 8
    bill = TB.bill_device(plan, hbm, plan.max_slots, slot)
    slack = bill.budget_bytes - bill.total_bytes
    pool = plan.activation_bytes + slack + 2 * slot + 1
    built = []

    def build(sv, params):
        built.append((sv.max_slots, params))
        return _StubEngine(sv, lambda n: pool, slot), 0.5

    eng, bill, resized_from, warmups = fit_to_budget(
        build, serve, plan, get_config("llada-8b"), hbm)
    assert resized_from == plan.max_slots and warmups == [0.5, 0.5]
    assert eng.serve.max_slots == plan.max_slots - 3 and bill.fits
    assert built[1][1] is not None          # the same weights, not redrawn
    fits = fit_to_budget(
        lambda sv, p: (_StubEngine(sv, lambda n: 0, slot), 0.1),
        serve, plan, get_config("llada-8b"), hbm)
    assert fits[2] is None and fits[1].fits and fits[0].serve is serve
    with pytest.raises(ValueError, match="graph pool") as e:
        fit_to_budget(lambda sv, p: (_StubEngine(
            sv, lambda n: pool * (n + 1), slot), 0.1), serve, plan,
            get_config("llada-8b"), hbm)
    assert "weights" in str(e.value) and "staging" in str(e.value)
