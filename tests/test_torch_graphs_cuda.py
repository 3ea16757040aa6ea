"""Captured stage entries (CUDA graphs) against the same entries run
eagerly, on the card.

Needs a CUDA device and ``nvcc``; every test takes the ``cuda`` fixture,
which skips with a reason when ``torch.cuda.is_available()`` is False. This
file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_graphs_cuda.py

A reduced float32 engine (TF32 off) serves the same requests on the same
weights with ``graphs=True`` and with ``graphs=False``: the committed ids,
every counter, the modeled clock and each kernel's launch count over the
run must be identical (the same kernels run on the same inputs; only their
launch path differs), and the graphed engine builds nothing after warmup.
The same holds under a seeded fault plan (a retried stage replays once),
with prefix sharing (copy-on-write promotes queued on the serving stream
ahead of the replays) and with int8 slots. The device bill re-sizes a
serve whose graph pool overruns its budget. Each ``iter_log`` row's device
times, from CUDA events around the stages, tile the run.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ServeConfig
from repro_torch.core.baselines import system_profiles
from repro_torch.core.budgeting import GUARD_BAND, MemoryPlan
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import Engine
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graphs import Field, StageGraphs
from repro_torch.core.kv_pool import KVPool
from repro_torch.data.workloads import PrefixSpec, make_trace, trace_prompts
from repro_torch.kernels import build
from repro_torch.params import init_params, param_bytes

COUNTERS = (
    "iterations", "refresh_steps", "reuse_steps", "committed_tokens",
    "deferred_steps", "peak_query_tokens", "refresh_tokens_real",
    "refresh_tokens_exec", "reuse_tokens_real", "reuse_tokens_exec",
    "logit_tokens_real", "logit_tokens_exec", "packed_refresh_calls",
    "padded_refresh_calls", "packed_reuse_calls", "padded_reuse_calls",
    "submitted", "finished", "dispatched_ahead", "streamed_events",
    "preemptions", "recomputed_tokens", "dispatch_retries",
    "alloc_fault_iters", "slow_fault_s", "shared_hits",
    "shared_cow_promotes", "phys_slots_peak")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _serve(system, logit_mode="fused", varlen_pack=None, **kw):
    base = ServeConfig(**dict(dict(
        max_num_batched_tokens=512, max_num_logits=64, block_size=8,
        steps_per_block=8, max_seq_len=128, max_slots=6,
        max_refresh_per_iter=2), **kw))
    serve = dataclasses.replace(system_profiles(base)[system],
                                use_flash_kernel=True, logit_mode=logit_mode)
    if varlen_pack is not None:
        serve = dataclasses.replace(serve, varlen_pack=varlen_pack)
    return serve


def _shared_prefix(vocab, n=8):
    """Shared-prefix prompts, every one arriving at once: co-resident
    twins are what the share ledger dedups."""
    trace = make_trace("shared-prefix", n, rps=8.0, seed=3,
                       prefix=PrefixSpec(n_prefixes=3, prefix_len=24))
    return [(p, 16, 0.0) for p in trace_prompts(trace, vocab, seed=3)]


def _run(cfg, serve, params, graphs, n=6, faults=None, shared=False):
    eng = Engine(cfg, serve, params=params, clock="modeled", device="cuda",
                 graphs=graphs, stream_cb=lambda ev: None,
                 faults=faults() if faults else None)
    eng.warmup()
    build.reset_counters()
    rng = np.random.default_rng(0)
    if shared:
        requests = _shared_prefix(cfg.vocab_size)
    else:
        requests = [(rng.integers(0, cfg.vocab_size - 1,
                                  int(rng.integers(8, 40))),
                     int(rng.integers(9, 30)), 0.004 * i) for i in range(n)]
    reqs = [eng.submit(p, gen_len=g, arrival=t, rid=i)
            for i, (p, g, t) in enumerate(requests)]
    stats = eng.run()
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls)
              for k, c in build.COUNTERS.items()}
    return eng, reqs, stats, counts


def _compare(arch, serve, **run):
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eg, rg, sg, cg = _run(cfg, serve, params, graphs=True, **run)
    ee, re_, se, ce = _run(cfg, serve, params, graphs=False, **run)
    for a, b in zip(rg, re_):
        assert np.array_equal(a.tokens, b.tokens), a.rid
    for k in COUNTERS:
        assert getattr(sg, k) == getattr(se, k), k
    assert eg.vtime == ee.vtime
    assert cg == ce
    assert sum(launches for launches, _ in cg.values()) > 0
    assert all(plain == 0 for _, plain in cg.values()), cg
    assert sg.compiles_warmup > 0 and sg.compiles_post_warmup == 0, \
        sg.compile_counts
    assert sum(sg.graph_replays.values()) > 0 and se.graph_replays == {}
    return sg


@pytest.mark.parametrize("arch", ["llada-8b", "mamba2-130m", "zamba2-7b"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_graphs_equal_eager_packed(cuda, arch, pipeline):
    st = _compare(arch, _serve("dllm-serve", pipeline=pipeline))
    assert st.packed_refresh_calls > 0 and st.packed_reuse_calls > 0
    assert (st.dispatched_ahead > 0) == pipeline


@pytest.mark.parametrize("arch,system", [
    ("mamba2-130m", "dllm-cache"), ("zamba2-7b", "fast-dllm"),
    ("zamba2-7b", "sparse-dllm"), ("phi3.5-moe-42b-a6.6b", "dllm-serve"),
    ("qwen3-moe-235b-a22b", "dllm-serve"),
    ("phi3.5-moe-42b-a6.6b", "sparse-dllm")])
def test_graphs_equal_eager_scan_padded_and_moe(cuda, arch, system):
    """The scan families' padded stages (the float32 ``ssd_scan`` and its
    capture gathers, the hybrid's causal split Reuse) and the MoE
    dispatch (sort, cumsum, scatter into the slot map, gathers) inside
    captured graphs."""
    st = _compare(arch, _serve(system))
    padded = system != "dllm-serve"
    assert (st.padded_refresh_calls > 0) == padded
    assert (st.packed_refresh_calls > 0) != padded


@pytest.mark.parametrize("system,mode", [("fast-dllm", "monolithic"),
                                         ("dllm-serve", "chunked")])
def test_graphs_equal_eager_profile_logit_modes(cuda, system, mode):
    """The profiles' own logit modes, the reference's plain path as torch
    ops (a baseline's one ``[N, V]`` pass; dllm-serve's chunks, all-padding
    ones masked on the device), inside captured graphs."""
    st = _compare("llada-8b", _serve(system, logit_mode=mode))
    assert st.logit_tokens_exec >= st.logit_tokens_real > 0


def test_graphs_equal_eager_preemption(cuda):
    """Two slots for six requests with a starvation threshold: preempted
    residents roll back their block, and the pipelined loop drops their
    in-flight commits, the same with graphs as without."""
    st = _compare("llada-8b", _serve("dllm-serve", max_slots=2,
                                     preempt_starvation_s=0.02))
    assert st.preemptions > 0


@pytest.mark.parametrize("system", ["dllm-serve", "sparse-dllm"])
def test_graphs_equal_eager_frontend(cuda, system):
    """musicgen-medium's frontend: the packed Refresh's prefix scatter into
    the stream (padding requests into the cut row), the padded
    ``[b, F + S]`` batch, and the payloads' staging field."""
    st = _compare("musicgen-medium", _serve(system))
    assert st.refresh_tokens_real > 0


def test_graphs_equal_eager_padded_two_refresh_chunks(cuda):
    """The request-level baseline refreshes a whole admitted batch in
    chunks of ``refresh_slots``: one iteration replays the same ``refresh``
    entry more than once, so the staging and each chunk's hidden rows must
    survive the next chunk's replay."""
    serve = _serve("sparse-dllm")
    st = _compare("llada-8b", serve)
    assert st.padded_refresh_calls > 0
    assert max(r["n_refresh"] for r in st.iter_log) > serve.refresh_slots


def test_capture_failure_names_the_stage(cuda):
    """A host sync inside a stage fails its capture; the error names the
    stage, and nothing falls back to eager."""
    g = StageGraphs(cuda, graphs=True)
    e = g.get("bad", (3,), lambda: (
        [Field("a", (3,), torch.int32)],
        lambda x: x["a"] + int(x["a"].sum().item())))
    e.host()["a"][:] = 1
    with pytest.raises(RuntimeError, match=r"stage bad\[3\]"):
        e()


@pytest.mark.parametrize("packed", [True, False])
def test_graphs_equal_eager_under_faults(cuda, packed):
    """``FaultPlan.seeded(1)`` with starvation preemption: dispatch faults
    are raised before the replay and retried, allocation faults and
    memory-pressure steals hold admission, a slow iteration is charged to
    the modeled clock; the same with graphs as without."""
    serve = _serve("dllm-serve", max_slots=4, preempt_starvation_s=0.05,
                   varlen_pack=packed)
    st = _compare("llada-8b", serve,
                  faults=lambda: FaultPlan.seeded(1, horizon=60))
    assert st.dispatch_retries > 0 and st.alloc_fault_iters > 0


@pytest.mark.parametrize("arch,packed", [("llada-8b", True),
                                         ("llada-8b", False),
                                         ("mamba2-130m", True)])
def test_graphs_equal_eager_prefix_sharing(cuda, arch, packed):
    """Shared-prefix traffic with sharing on: deduplicated rows write the
    scratch slot, Reuse rows read their owner's row, and copy-on-write
    promotes are row copies queued ahead of the replay that overwrites the
    old owner."""
    serve = _serve("dllm-serve", prefix_sharing=True, varlen_pack=packed,
                   preempt_starvation_s=0.05)
    st = _compare(arch, serve, shared=True)
    assert st.shared_hits > 0 and st.shared_cow_promotes > 0


@pytest.mark.parametrize("sharing", [False, True])
def test_graphs_equal_eager_int8_slots(cuda, sharing):
    """int8 slots: the Refresh entries quantize inside their captured
    write, the Reuse entries dequantize at their KV load."""
    serve = _serve("dllm-serve", kv_quant="int8", prefix_sharing=sharing)
    st = _compare("llada-8b", serve, shared=sharing)
    assert st.packed_reuse_calls > 0


def test_packed_reuse_reads_the_pool_in_place(cuda, monkeypatch):
    """A served packed run takes the in-place Reuse: every ``iter_log``
    row's ``reuse_in_place`` counts its Reuse rows, the slot pool is never
    gathered after warmup (a replay counts the gathers its capture made),
    and the ids are the gathered path's (the same engine with the pool's
    in-place reads refused). An int8 pool still gathers."""
    cfg = reduced(get_config("llada-8b"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    serve = _serve("dllm-serve")
    eng, reqs, st, counts = _run(cfg, serve, params, graphs=True)
    assert st.packed_reuse_calls > 0
    assert all(r["reuse_in_place"] == r["n_reuse"] for r in st.iter_log)
    assert sum(r["reuse_in_place"] for r in st.iter_log) > 0
    assert counts["kv_pool_gather"] == (0, 0)
    assert counts["flash_varlen_cross_pool"][0] > 0
    assert counts.get("flash_varlen_cross", (0, 0)) == (0, 0)
    with monkeypatch.context() as m:
        m.setattr(KVPool, "rows_in_place", property(lambda self: False))
        _, gathered, gst, gcounts = _run(cfg, serve, params, graphs=True)
    for a, b in zip(reqs, gathered):
        assert np.array_equal(a.tokens, b.tokens), a.rid
    assert all(r["reuse_in_place"] == 0 for r in gst.iter_log)
    assert gcounts["kv_pool_gather"][0] == gst.packed_reuse_calls > 0
    assert gcounts["flash_varlen_cross"][0] > 0
    serve = _serve("dllm-serve", kv_quant="int8")
    _, _, qst, qcounts = _run(cfg, serve, params, graphs=True)
    assert all(r["reuse_in_place"] == 0 for r in qst.iter_log)
    assert qcounts["kv_pool_gather"][0] == qst.packed_reuse_calls > 0


def test_device_bill_resizes_an_overrunning_serve(cuda):
    """A plan with no weights or activations, on a budget one byte short
    of the engine's weights, its slot pool (six slots and the scratch
    slot), its graph pool and its staging: the bill finds the overrun after warmup and
    re-sizes the serve to five slots, built and captured again on the
    same weights; that serve fits, serves, and builds nothing after
    warmup."""
    from repro_torch.launch.serve import fit_to_budget

    cfg = reduced(get_config("llada-8b"))
    serve = _serve("dllm-serve")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")

    def build_engine(sv, p):
        eng = Engine(cfg, sv, params=params if p is None else p,
                     clock="modeled", device="cuda")
        return eng, eng.warmup()

    probe, _ = build_engine(serve, None)
    pool, staging = probe.graphs.pool_bytes(), probe.graphs.staging_bytes()
    slot = probe.pool.slot_bytes()
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    assert pool > 0 and staging > 0 and slot > 0
    n = serve.max_slots
    plan = MemoryPlan(weights_bytes=0, activation_bytes=0, logit_bytes=0,
                      slot_bytes=slot, kv_pool_bytes=n * slot, max_slots=n,
                      phys_slots=n)
    target = param_bytes(params) + (n + 1) * slot + pool + staging - 1
    hbm = int(target / (1 - GUARD_BAND))
    while hbm - int(hbm * GUARD_BAND) > target:
        hbm -= 1
    while hbm - int(hbm * GUARD_BAND) < target:
        hbm += 1
    eng, bill, resized_from, warmups = fit_to_budget(
        build_engine, serve, plan, cfg, hbm)
    assert resized_from == n and eng.serve.max_slots == n - 1
    assert bill.fits and len(warmups) == 2 and bill.graph_pool_bytes > 0
    assert eng.params is params
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(rng.integers(0, cfg.vocab_size - 1, 20), gen_len=16,
                   arrival=0.0, rid=i)
    st = eng.run()
    assert st.finished == 6 and st.compiles_post_warmup == 0


def test_device_bill_of_an_eager_serve_measures_the_logit_peak(cuda):
    """Without graphs nothing sits in a graph pool, and the bill takes the
    measured logit-stage peak of the serve's C1 mode at the plan geometry
    in place of the plan's logit term."""
    from repro_torch.core.budgeting import measure_logit_peak, plan_memory
    from repro_torch.launch.serve import PLAN_GEOMETRY, device_bill

    cfg = reduced(get_config("llada-8b"))
    serve = _serve("dllm-serve")
    eng = Engine(cfg, serve, clock="modeled", device="cuda", graphs=False)
    eng.warmup()
    full = get_config("llada-8b")
    plan_serve = dataclasses.replace(serve, **PLAN_GEOMETRY)
    plan = plan_memory(full, plan_serve, 80 << 30)
    bill = device_bill(eng, plan, full, 80 << 30)
    peak = measure_logit_peak(full, plan_serve,
                              plan_serve.max_num_batched_tokens)["fused"]
    assert bill.graph_pool_bytes == 0 and bill.staging_bytes > 0
    assert bill.activation_bytes == \
        plan.activation_bytes - plan.logit_bytes + peak


@pytest.mark.parametrize("system", ["dllm-serve", "sparse-dllm"])
def test_stage_device_times_tile_the_run(cuda, monkeypatch, system):
    """Each ``iter_log`` row's CUDA-event times: a stage that ran has
    positive device time and one that did not reads 0.0 (the padded
    Refresh's chunks add up), the stages fit inside the iteration's span,
    and the iterations' spans and the gaps between them tile the run from
    the first stage's start to the last copy's end. The events are taken
    fresh here (never from the free list), so the first and the last stay
    readable after the run."""
    taken = []

    def take(self):
        ev = torch.cuda.Event(enable_timing=True)
        taken.append(ev)
        return ev
    monkeypatch.setattr(engine_mod._StageClock, "take", take)
    cfg = reduced(get_config("llada-8b"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    _, _, st, _ = _run(cfg, _serve(system), params, graphs=True, n=8)
    rows = list(st.iter_log)
    assert len(rows) > 4 and any(r["n_refresh"] for r in rows)
    # cudaEventElapsedTime resolves about half a microsecond a reading
    tick = 1e-6
    for i, r in enumerate(rows):
        for n, key in (("n_refresh", "refresh_dev_s"),
                       ("n_reuse", "reuse_dev_s")):
            assert (r[key] > 0.0) if r[n] else (r[key] == 0.0), (i, key)
        assert r["logit_dev_s"] > 0.0
        stages = r["refresh_dev_s"] + r["reuse_dev_s"] + r["logit_dev_s"]
        assert stages <= r["iter_dev_s"] + 3 * tick, i
        assert (r["gap_dev_s"] is None) == (i == 0), i
    tiled = sum(r["iter_dev_s"] + (r["gap_dev_s"] or 0.0) for r in rows)
    whole = taken[0].elapsed_time(taken[-1]) / 1e3
    assert tiled == pytest.approx(whole, rel=0.01)
