"""The slice as a whole: the JAX engine and the port's engine serve the same
requests on the same weights (reduced llada-8b, float32) under every
serving system — dllm-serve (phase scheduler, token-packed) and the three
baselines (request-level scheduler, padded) — with the kernel paths on
(``use_flash_kernel=True``, ``logit_mode="fused"``) and with each profile's
own flags, the synchronous loop and the modeled clock; the port runs on the
CPU, i.e. on its kernels' plain versions.

Exact: every committed token id, every EngineStats counter and the modeled
clock. The only fields left out are host wall-clock timings and the JAX
compile counters, which measure the host and XLA, not the serving.
"""
import dataclasses

import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import numpy as np
import pytest

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import ablation_profiles as jablation
from repro.core.baselines import system_profiles as jprofiles
from repro.core.engine import Engine as JEngine
from repro.core.request import Request as JRequest
from repro.core.scheduler import make_scheduler as jmake_scheduler
from repro.launch.serve import run_serve as jrun_serve
from repro.models import backbone as JBB
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import diffusion
from repro_torch.core.baselines import ablation_profiles as tablation
from repro_torch.core.baselines import system_profiles as tprofiles
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.request import Request as TRequest, State
from repro_torch.core.scheduler import (RequestLevelScheduler,
                                        make_scheduler as tmake_scheduler)
from repro_torch.launch.serve import run_serve as trun_serve
from repro_torch.params import from_jax
from torch_testing import cached

HOST_TIMES = {"host_plan_s", "host_fill_s", "sync_wait_s",
              "overlapped_host_s"}
JAX_ONLY = {"compile_counts", "compiles_warmup"}
SERVE = dict(max_num_batched_tokens=64, max_num_logits=32, block_size=8,
             steps_per_block=8, max_seq_len=96, max_slots=4,
             max_refresh_per_iter=2, pipeline=False)


def _serve(cls, profiles):
    s = profiles(cls(**SERVE))["dllm-serve"]
    return dataclasses.replace(s, use_flash_kernel=True, logit_mode="fused")


def _requests(vocab):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab - 1, int(rng.integers(8, 24))),
             int(rng.integers(9, 30)), float(i) * 0.004) for i in range(6)]


def reference_params(arch, **overrides):
    """The reference's reduced weights (PRNGKey 3) and their numpy tree,
    once per process."""
    def make():
        jp = JBB.init_params(reduced(ARCHS[arch], **overrides),
                             jax.random.PRNGKey(3))
        return jp, jax.tree.map(np.asarray, jp)
    return cached(("params", arch, overrides), make)


def reference_serve(jserve, requests, arch="llada-8b", **overrides):
    """The reference engine's serve of ``requests`` (modeled clock), once
    per process: each request's tokens and times, the stats and vtime."""
    def run():
        je = JEngine(reduced(ARCHS[arch], **overrides), jserve,
                     params=reference_params(arch, **overrides)[0],
                     clock="modeled")
        jreqs = [je.submit(p, gen_len=g, arrival=t, rid=i)
                 for i, (p, g, t) in enumerate(requests)]
        js = je.run()
        return ([(r.tokens.copy(), (r.t_admitted, r.t_first_commit,
                                    r.t_finished)) for r in jreqs],
                js, je.vtime)
    return cached(("serve", arch, overrides, jserve, requests), run)


def _serve_both(jserve, tserve, requests=None, check_deferred=True,
                arch="llada-8b", **overrides):
    """Serve the same requests on both engines (the reduced ``arch``, with
    ``overrides`` passed to both packages' ``reduced``); ids, request
    times, every EngineStats counter and vtime must be equal."""
    tcfg = treduced(get_config(arch), **overrides)
    requests = requests or _requests(tcfg.vocab_size)
    jreqs, js, vtime = reference_serve(jserve, requests, arch, **overrides)
    te = TEngine(tcfg, tserve,
                 params=from_jax(reference_params(arch, **overrides)[1],
                                 tcfg, "cpu"),
                 clock="modeled", device="cpu")
    treqs = [te.submit(p, gen_len=g, arrival=t, rid=i)
             for i, (p, g, t) in enumerate(requests)]
    ts = te.run()
    assert all(r.state == State.FINISHED for r in treqs)
    assert ts.reuse_steps > 0
    if check_deferred:
        assert ts.deferred_steps > 0
    for (tokens, times), b in zip(jreqs, treqs):
        assert np.array_equal(tokens, b.tokens), b.rid
        assert times == (b.t_admitted, b.t_first_commit, b.t_finished)
    assert vtime == te.vtime
    for f in dataclasses.fields(js):
        if f.name in HOST_TIMES | JAX_ONLY:
            continue
        want, got = getattr(js, f.name), getattr(ts, f.name)
        if f.name == "iter_log":
            drop = {"plan_s", "fill_s", "sync_s"}
            want = [{k: v for k, v in r.items() if k not in drop}
                    for r in want]
            got = [{k: v for k, v in r.items() if k not in drop}
                   for r in got]
        assert want == got, f.name
    return ts


def test_engine_matches_reference_exactly():
    _serve_both(_serve(JServe, jprofiles), _serve(TServe, tprofiles))


# the baselines charge every resident its whole length: a budget that fits
# three requests at once, refreshed in serial chunks of two
BASE = dict(SERVE, max_num_batched_tokens=160)


@pytest.mark.parametrize("system,kernels", [
    ("fast-dllm", None), ("fast-dllm", True), ("dllm-cache", None),
    ("dllm-cache", True), ("sparse-dllm", None), ("sparse-dllm", True),
    ("dllm-serve", None)])
def test_systems_match_reference_exactly(system, kernels):
    """Every system of ``system_profiles`` with its own flags
    (``kernels=None``: the plain fallbacks and monolithic or chunked logits)
    and with the kernel paths; dllm-serve with the kernels is
    :func:`test_engine_matches_reference_exactly`."""
    def serve(cls, profiles):
        s = profiles(cls(**BASE))[system]
        if kernels:
            s = dataclasses.replace(s, use_flash_kernel=True,
                                    logit_mode="fused")
        return s
    ts = _serve_both(serve(JServe, jprofiles), serve(TServe, tprofiles),
                     check_deferred=False)
    padded = system != "dllm-serve"
    assert (ts.padded_refresh_calls > 0) == padded
    assert (ts.padded_reuse_calls > 0) == padded
    assert (ts.packed_refresh_calls > 0) != padded


@pytest.mark.parametrize("profile", ["+engine", "+scheduler"])
def test_ablation_profiles_match_reference_exactly(profile):
    """The §6.6 ablation steps that no system profile covers: the
    request-level scheduler on the packed path with monolithic logits
    (``+engine``), then the phase scheduler with them (``+scheduler``)."""
    ts = _serve_both(jablation(JServe(**BASE))[profile],
                     tablation(TServe(**BASE))[profile],
                     check_deferred=False)
    assert ts.packed_refresh_calls > 0 and ts.padded_refresh_calls == 0


def test_request_level_scheduler_plans_match_reference():
    """Plan for plan: static batches admitted only when the previous one
    drained, worst-case budget charges, the same refresh/reuse split,
    deferrals, rejections and sheds, with the requests advanced between
    plans by the reference's commit counts."""
    rng = np.random.default_rng(12)
    cfgs = (JServe(**BASE, scheduler="request"),
            TServe(**BASE, scheduler="request"))
    scheds = [jmake_scheduler(cfgs[0]), tmake_scheduler(cfgs[1])]
    assert isinstance(scheds[1], RequestLevelScheduler)
    for i in range(9):
        p = rng.integers(0, 100, int(rng.integers(8, 40)))
        g = int(rng.integers(8, 40))
        t, dl = 0.01 * i, (0.05 if i == 7 else float("inf"))
        for sch, cls, cfg in zip(scheds, (JRequest, TRequest), cfgs):
            sch.submit(cls(rid=i, prompt=p.astype(np.int32), gen_len=g,
                           arrival=t, cfg=cfg, mask_id=0, deadline=dl))
    now, n_plans = 0.0, 0
    while scheds[0].has_work:
        plans = [sch.plan(now) for sch in scheds]
        for f in ("refresh", "reuse", "deferred", "admitted", "rejected",
                  "shed"):
            want, got = ([r.rid for r in getattr(pl, f)] for pl in plans)
            assert want == got, (n_plans, f)
        for sch, pl in zip(scheds, plans):
            for r in pl.refresh + pl.reuse:
                left = sch.cfg.steps_per_block - r.step_in_block
                r.advance_control(diffusion.commit_count(r.masked_left, left),
                                  now)
                if r.state.value == "finished":
                    sch.finish(r)
        assert scheds[1].has_work == scheds[0].has_work
        now += 0.01
        n_plans += 1
    assert n_plans > 10


# the port's own keys: replays per captured stage entry and the captured
# graphs' pool (none and 0 on the CPU)
PORT_ONLY = {"graph_replays", "graph_pool_bytes"}


@pytest.mark.parametrize("workload", ["burst", "livebench"])
def test_run_serve_json_matches_reference(workload):
    """Both launchers on the pipelined loop with streaming: the dispatched-
    ahead iterations and the streamed events are compared too."""
    kw = dict(use_reduced=True, seed=1, kernels=True, clock="modeled",
              size_by_profiler=False, pipeline=True, stream=True,
              max_seq_len=128, max_num_batched_tokens=384, max_slots=6)
    want = jrun_serve("llada-8b", "dllm-serve", workload, 4.0, 4, **kw)
    got = trun_serve("llada-8b", "dllm-serve", workload, 4.0, 4,
                     device="cpu", **kw)
    assert set(got) == set(want) | PORT_ONLY
    assert got["n_finished"] == 4
    assert got["pipeline"] is True and got["dispatched_ahead"] > 0
    assert got["streamed_events"] > 0 and got["graph_replays"] == {}
    assert got["graph_pool_bytes"] == 0
    skip = HOST_TIMES | JAX_ONLY | {"warmup_s", "wall_clock_s", "wall_tok_s",
                                    "overlap_frac", "compiles_post_warmup"}
    for k in sorted(set(want) - skip):
        assert got[k] == want[k], k


def test_run_serve_baseline_json_matches_reference():
    """A baseline through the launcher with its profile's own flags
    (``kernels=None``): padded stages, monolithic logits."""
    kw = dict(use_reduced=True, seed=2, kernels=None, clock="modeled",
              size_by_profiler=False, pipeline=False, max_seq_len=96,
              max_num_batched_tokens=256, max_slots=4, max_num_logits=32)
    want = jrun_serve("llada-8b", "sparse-dllm", "burst", 4.0, 3, **kw)
    got = trun_serve("llada-8b", "sparse-dllm", "burst", 4.0, 3,
                     device="cpu", **kw)
    assert got["n_finished"] == 3 and got["padded_reuse_calls"] > 0
    assert set(got) == set(want) | PORT_ONLY
    skip = HOST_TIMES | JAX_ONLY | {"warmup_s", "wall_clock_s", "wall_tok_s",
                                    "overlap_frac", "compiles_post_warmup"}
    for k in sorted(set(want) - skip):
        assert got[k] == want[k], k


def test_unported_engine_options_raise():
    tcfg = treduced(get_config("llada-8b"))
    base = _serve(TServe, tprofiles)
    # the pipelined loop is ported: the reference's default constructs
    assert TEngine(tcfg, dataclasses.replace(base, pipeline=True),
                   device="cpu").serve.pipeline
    for bad in (dict(mesh_shape=(1, 2)),
                dict(prefix_sharing=True), dict(kv_quant="int8")):
        with pytest.raises(NotImplementedError):
            TEngine(tcfg, dataclasses.replace(base, **bad), device="cpu")
    # the profiler bills what it can serve, and raises on the rest
    from repro_torch.core.budgeting import plan_memory
    for bad in (dict(kv_quant="int8"), dict(prefix_sharing=True),
                dict(mesh_shape=(1, 2))):
        with pytest.raises(NotImplementedError):
            plan_memory(get_config("llada-8b"),
                        dataclasses.replace(base, **bad), 24 << 30)


def test_cuda_engine_requires_the_kernel_paths(monkeypatch):
    """On CUDA the engine refuses the plain attention fallbacks, for every
    system (checked before any weight is drawn, with the device resolution
    stubbed), and takes every system's own logit mode (monolithic,
    chunked: the reference's plain path, torch ops on the card)."""
    import torch
    from repro_torch.core import engine as tengine
    from repro_torch.params import init_params
    monkeypatch.setattr(tengine.devices, "resolve",
                        lambda d: torch.device("cuda"))
    tcfg = treduced(get_config("llada-8b"))
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    modes = set()
    for system, s in tprofiles(TServe(**SERVE)).items():
        with pytest.raises(ValueError, match="CUDA"):
            TEngine(tcfg, dataclasses.replace(s, logit_mode="fused"))
        eng = TEngine(tcfg, dataclasses.replace(s, use_flash_kernel=True),
                      params=params, graphs=False)
        assert eng.device.type == "cuda"
        modes.add(eng.serve.logit_mode)
    assert modes == {"monolithic", "chunked"}


def test_cuda_device_without_a_card_raises(monkeypatch):
    """The entry points run on the card by default and never fall back to
    the CPU quietly."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = treduced(get_config("llada-8b"))
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(tcfg, _serve(TServe, tprofiles))


def test_kv_pool_ledger_and_in_place_scatter():
    """Slot ledger as in the reference (generations bump on free; double
    take / double free raise) and an in-place scatter/gather on the slot
    axis, with the scratch slot at ``max_slots``."""
    import torch
    from repro_torch.core.kv_pool import KVPool
    from repro_torch.models.sparse_select import PackedKV
    pool = KVPool(3, "cpu")
    assert (pool.take(1), pool.generation(1)) == (0, 0)
    with pytest.raises(RuntimeError):
        pool.take(1)
    pool.free([1])
    assert pool.generation(1) == 1
    with pytest.raises(RuntimeError):
        pool.free([1])
    cache = PackedKV(torch.arange(2 * 2 * 2 * 4 * 1.0).reshape(2, 2, 2, 4, 1),
                     torch.ones(2, 2, 2, 4, 1),
                     torch.arange(32, dtype=torch.int32).reshape(2, 2, 2, 4),
                     torch.ones(2, 2, 2, 4, dtype=torch.bool))
    pool.write([2, pool.scratch_slot], cache)
    before = pool.cache.k.data_ptr()
    pool.write([0, 2], cache)
    assert pool.cache.k.data_ptr() == before        # updated in place
    assert pool.cache.k.shape == (2, 4, 2, 4, 1)
    got = pool.gather([2, 0])
    assert torch.equal(got.k, cache.k.flip(1)) and torch.equal(
        got.pos, cache.pos.flip(1))
    assert not pool.cache.valid[:, 1].any()         # untouched slot
