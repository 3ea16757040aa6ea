"""The port's pipelined loop and its per-bucket stage entries, on the CPU.

* The pipelined loop (``ServeConfig.pipeline=True``, dispatch-ahead) of the
  port against the port's synchronous loop and against the reference's
  pipelined loop (``tests/test_engine_pipeline.py``), on the same weights
  and requests (reduced, float32, modeled clock): exact ids, every
  EngineStats counter, the modeled clock, the reference's
  ``dispatched_ahead``, and between the port's two loops the final slot
  pool; for llada-8b packed and padded and mamba2-130m packed (its padded
  path is not ported).
* The streaming callback: the port's events equal the reference's, event
  for event (rid, block_idx, n_committed, finished, t, tokens).
* Bucket cover: every stage entry a served run requests, under burst and
  livebench traffic, is one :func:`stage_keys` lists, so warmup builds all
  of them and nothing is built mid-serve.
* :mod:`repro_torch.core.graphs` entries on the CPU: eager, on their host
  buffers.

The reference's faults-and-preemption case (``test_engine_pipeline.py``)
waits for fault injection in the port (ROADMAP Queue A, item 7).
"""
import dataclasses

import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import system_profiles as jprofiles
from repro.core.engine import Engine as JEngine
from repro.models import backbone as JBB
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.baselines import ablation_profiles as tablation
from repro_torch.core.baselines import system_profiles as tprofiles
from repro_torch.core.engine import Engine as TEngine, stage_keys
from repro_torch.core.graphs import Field, StageGraphs
from repro_torch.core.kv_pool import tree_leaves
from repro_torch.core.request import State
from repro_torch.data.workloads import make_trace, trace_prompts
from repro_torch.params import from_jax
from torch_testing import cached

HOST_TIMES = {"host_plan_s", "host_fill_s", "sync_wait_s",
              "overlapped_host_s"}
JAX_ONLY = {"compile_counts", "compiles_warmup"}
# what differs between the port's two loops by design
LOOP_ONLY = {"dispatched_ahead", "graph_replays"}
SERVE = dict(max_num_batched_tokens=64, max_num_logits=32, block_size=8,
             steps_per_block=8, max_seq_len=96, max_slots=4,
             max_refresh_per_iter=2)


def _serve(cls, profiles, pipeline, packed=True):
    s = profiles(cls(**SERVE, pipeline=pipeline))["dllm-serve"]
    return dataclasses.replace(s, use_flash_kernel=True, logit_mode="fused",
                               varlen_pack=packed)


def _requests(vocab, n=5):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab - 1, int(rng.integers(8, 30))),
             int(rng.integers(9, 30)), 0.004 * i) for i in range(n)]


def _stats_rows(stats, skip):
    out = {}
    for f in dataclasses.fields(stats):
        if f.name in skip:
            continue
        v = getattr(stats, f.name)
        if f.name == "iter_log":
            drop = {"plan_s", "fill_s", "sync_s"}
            v = [{k: x for k, x in r.items() if k not in drop} for r in v]
        out[f.name] = v
    return out


def _run_port(tcfg, serve, params, requests, events=None):
    eng = TEngine(tcfg, serve, params=params, clock="modeled", device="cpu",
                  stream_cb=events.append if events is not None else None)
    reqs = [eng.submit(p, gen_len=g, arrival=t, rid=i)
            for i, (p, g, t) in enumerate(requests)]
    stats = eng.run()
    assert all(r.state == State.FINISHED for r in reqs)
    return eng, reqs, stats


def _reference(arch, packed):
    """The reference's pipelined serve with its stream events, once per
    process (the loop test and the stream test compare against it)."""
    def run():
        jcfg = reduced(ARCHS[arch])
        jp = JBB.init_params(jcfg, jax.random.PRNGKey(3))
        events = []
        je = JEngine(jcfg, _serve(JServe, jprofiles, True, packed),
                     params=jp, clock="modeled", stream_cb=events.append)
        jreqs = [je.submit(p, gen_len=g, arrival=t, rid=i)
                 for i, (p, g, t) in enumerate(_requests(jcfg.vocab_size))]
        js = je.run()
        return je.vtime, jreqs, js, events, jax.tree.map(np.asarray, jp)
    return cached(("pipelined", arch, packed), run)


def _three_loops(arch, packed, jevents=None, tevents=None):
    vtime, jreqs, js, events, tree = _reference(arch, packed)
    if jevents is not None:
        jevents.extend(events)
    tcfg = treduced(get_config(arch))
    tp = from_jax(tree, tcfg, "cpu")
    requests = _requests(tcfg.vocab_size)
    # every loop streams its commits, as the reference's serve did
    pipe = _run_port(tcfg, _serve(TServe, tprofiles, True, packed), tp,
                     requests, [] if tevents is None else tevents)
    sync = _run_port(tcfg, _serve(TServe, tprofiles, False, packed), tp,
                     requests, [])
    return (vtime, jreqs, js), pipe, sync


@pytest.mark.parametrize("arch,packed", [("llada-8b", True),
                                         ("llada-8b", False),
                                         ("mamba2-130m", True)])
def test_pipelined_loop_matches_reference_and_sync(arch, packed):
    (jvtime, jreqs, js), (pe, preqs, ps), (se, sreqs, ss) = \
        _three_loops(arch, packed)
    for a, b, c in zip(jreqs, preqs, sreqs):
        assert np.array_equal(a.tokens, b.tokens), a.rid
        assert np.array_equal(b.tokens, c.tokens), a.rid
        assert (a.t_admitted, a.t_first_commit, a.t_finished) == \
            (b.t_admitted, b.t_first_commit, b.t_finished) == \
            (c.t_admitted, c.t_first_commit, c.t_finished)
    assert jvtime == pe.vtime == se.vtime
    # the reference's pipelined loop field for field, dispatched_ahead too
    want = _stats_rows(js, HOST_TIMES | JAX_ONLY)
    got = _stats_rows(ps, HOST_TIMES | JAX_ONLY)
    assert {k: got[k] for k in want} == want
    assert ps.dispatched_ahead > 0 and ps.overlap_frac > 0.0
    assert (ps.packed_refresh_calls > 0) == packed
    # the port's synchronous loop: the same, but dispatched nothing ahead
    assert _stats_rows(ss, HOST_TIMES | LOOP_ONLY) == \
        _stats_rows(ps, HOST_TIMES | LOOP_ONLY)
    assert ss.dispatched_ahead == 0 and ss.overlap_frac == 0.0
    # the slot pools saw the same writes
    for a, b in zip(tree_leaves(pe.pool.cache), tree_leaves(se.pool.cache)):
        assert torch.equal(a, b)


def test_stream_events_match_reference():
    jev, tev = [], []
    (_, jreqs, js), (_, preqs, ps), _ = _three_loops("llada-8b", True,
                                                     jev, tev)
    assert len(tev) == len(jev) == ps.streamed_events == js.streamed_events
    assert len(tev) > 0
    for a, b in zip(jev, tev):
        assert set(a) == set(b)
        for k in ("rid", "block_idx", "n_committed", "finished", "t"):
            assert a[k] == b[k], k
        assert np.array_equal(np.asarray(a["tokens"]), b["tokens"])
    assert sum(e["n_committed"] for e in tev) == ps.committed_tokens
    assert sum(e["finished"] for e in tev) == len(preqs)


# the launcher's geometry, and the one the bucket-cover serves run at: the
# launcher's cut to S = 128, 6 slots, 512 tokens and 64 logits (the same
# bounds, fewer buckets to serve through)
LAUNCHER = dict(max_seq_len=256, block_size=8, steps_per_block=8,
                max_slots=12, max_num_batched_tokens=1024,
                max_num_logits=128, max_refresh_per_iter=4)
COVER = dict(LAUNCHER, max_seq_len=128, max_slots=6,
             max_num_batched_tokens=512, max_num_logits=64)


def _profile(name, geometry=LAUNCHER):
    base = TServe(**geometry)
    if name == "+engine":
        return tablation(base)[name]
    return dataclasses.replace(tprofiles(base)[name], use_flash_kernel=True,
                               logit_mode="fused")


@pytest.mark.parametrize("system", ["dllm-serve", "sparse-dllm", "+engine"])
@pytest.mark.parametrize("workload", ["burst", "livebench"])
def test_warmup_covers_every_requested_bucket(system, workload):
    """``COVER`` (reduced llada-8b): after warmup, serving a trace builds no
    entry, and the keys it used are a part of ``stage_keys``; dllm-serve,
    a padded baseline, and the request-level scheduler on the packed path
    (``+engine``: the fused Refresh spans up to ``max_slots``
    requests)."""
    _warmup_covers("llada-8b", system, workload)


@pytest.mark.parametrize("arch,system", [("zamba2-7b", "sparse-dllm"),
                                         ("mamba2-130m", "fast-dllm")])
def test_warmup_covers_every_requested_bucket_scan_padded(arch, system):
    """The same for the scan families' padded stages, whose slot pool
    holds nested SSMCache / HybridCache trees."""
    _warmup_covers(arch, system, "livebench")


def _warmup_covers(arch, system, workload):
    cfg = treduced(get_config(arch))
    serve = _profile(system, COVER)
    S = serve.max_seq_len
    eng = TEngine(cfg, serve, clock="modeled", device="cpu")
    eng.warmup()
    listed = {(n, k) for n, ks in stage_keys(serve, cfg).items() for k in ks}
    assert set(eng.graphs.entries) == listed
    assert eng.stats.compiles_warmup == len(listed)
    trace = make_trace(workload, 12, 50.0, seed=0, scale=0.15)
    for i, (t, p) in enumerate(zip(trace, trace_prompts(trace, cfg.vocab_size,
                                                         seed=0))):
        gl = max(8, min(t.gen_len, S - len(p) - 8))
        eng.submit(p[: min(len(p), S - gl - 8)], gen_len=gl,
                   arrival=t.arrival, rid=i)
    stats = eng.run()
    assert stats.finished == 12
    assert stats.compiles_post_warmup == 0, stats.compile_counts
    used = {k for k, e in eng.graphs.entries.items() if e.calls}
    assert used <= listed and len(used) >= 4, sorted(used)


def test_stage_keys_at_the_run_serve_defaults():
    """The entries warmup builds at the launcher's geometry (S = 256,
    Sb = 8, 1,024 tokens, 12 slots, 4 Refreshes a step, token bucket 128)."""
    cfg = get_config("llada-8b")
    keys = stage_keys(_profile("dllm-serve"), cfg)
    assert keys["refresh_packed"] == [(128, 1), (256, 1)] + [
        (t, 2) for t in range(128, 513, 128)] + [
        (t, 4) for t in range(128, 1025, 128)]
    assert keys["reuse_packed"] == [(r,) for r in range(1, 13)]
    assert keys["decode_packed"] == [(8 * k,) for k in range(1, 13)]
    padded = stage_keys(_profile("sparse-dllm"), cfg)
    assert padded == {"refresh": [(1,), (2,), (4,)],
                      "reuse": [(1,), (2,), (4,), (8,), (16,)],
                      "decode": [(8,), (16,), (32,), (64,), (128,)]}


def test_cpu_entries_run_eagerly_on_their_host_buffers():
    g = StageGraphs(torch.device("cpu"), graphs=True)
    assert not g.capture and g.pool_bytes() == 0
    make = lambda: ([Field("a", (4,), torch.int32, 7),  # noqa: E731
                     Field("m", (4,), torch.bool, False),
                     Field("h", (2, 3), torch.float32, host=False)],
                    lambda x: torch.where(x["m"], x["a"], -x["a"])
                    + x["h"].sum().to(torch.int32))
    e = g.get("stage", (4,), make)
    assert g.get("stage", (4,), make) is e
    assert g.compile_counts == {"stage": 1}
    x = e.host()
    assert x["a"].tolist() == [7] * 4 and not x["m"].any()
    x["a"][:2] = 3
    x["m"][1:] = True
    e.inputs["h"] += 1.0
    assert e().tolist() == [3, 9, 13, 13]
    x = e.host()                      # every field back to its fill value
    assert x["a"].tolist() == [7] * 4 and not x["m"].any()
    assert e().tolist() == [-1] * 4
    assert e.calls == 2 and e.replays == 0 and g.replays == {}
    res = e.to_host(torch.arange(3, dtype=torch.int32))
    assert res.wait().tolist() == [0, 1, 2]
    res.release()
    with pytest.raises(RuntimeError, match="without host"):
        e()
