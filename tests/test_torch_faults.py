"""The port's fault injection against the reference's (``tests/test_faults.py``
scenarios), on the same weights (reduced llada-8b, float32, the modeled
clock, the pipelined loop unless a case says otherwise).

* ``FaultPlan.seeded`` gives the reference's event list, and the two plans
  activate and hand out the same faults iteration by iteration.
* Chaos runs (seeded plans: dispatch faults retried with backoff,
  allocation faults, memory-pressure steals, slow iterations, with
  starvation preemption on) on the padded path at seeds 1, 3 and 5 and on
  the packed path: exact ids, request times and outcomes, every
  EngineStats counter, ``vtime`` and the faults injected; no slot leaked.
* The port's synchronous loop under the same schedule equals its
  pipelined loop (and so the reference's).
* One case each for a permanent dispatch fault (``FaultError`` past
  ``fault_retries``, as the reference raises it), an allocation deferral,
  a memory-pressure steal and a slow iteration.
"""
import dataclasses

import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import numpy as np
import pytest

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core import faults as JF
from repro.core.engine import Engine as JEngine
from repro.models import backbone as JBB
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import faults as TF
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.request import State
from repro_torch.params import from_jax
from test_torch_engine import HOST_TIMES, JAX_ONLY
from torch_testing import ITER_LOG_DROP, cached

# the reference's chaos geometry (tests/test_faults.py BASE)
BASE = dict(max_num_batched_tokens=512, max_num_logits=64, block_size=8,
            steps_per_block=8, max_seq_len=128, max_slots=4,
            max_refresh_per_iter=2, selection="head", scheduler="phase",
            logit_mode="chunked", preempt_starvation_s=0.05)
PACKED = dict(varlen_pack=True, token_bucket=64)
LOOP_ONLY = {"dispatched_ahead", "graph_replays"}


def _params():
    def make():
        jcfg = reduced(ARCHS["llada-8b"])
        jp = JBB.init_params(jcfg, jax.random.PRNGKey(0))
        return jp, jax.tree.map(np.asarray, jp)
    return cached(("faults-params",), make)


def _plan(mod, spec):
    """``spec``: ("seeded", seed) or ("events", ((kind, kwargs), ...))."""
    if spec[0] == "seeded":
        return mod.FaultPlan.seeded(spec[1], horizon=60)
    return mod.FaultPlan([mod.FaultEvent(kind, **dict(kw))
                          for kind, kw in spec[1]])


def _requests(vocab, n):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab - 1, int(rng.integers(8, 40))), 16,
             0.05 * i) for i in range(n)]


def _serve(engine_cls, mod, cfg, params, serve, spec, n):
    plan = _plan(mod, spec)
    kw = {} if engine_cls is JEngine else dict(device="cpu")
    eng = engine_cls(cfg, serve, params=params, seed=0, clock="modeled",
                     faults=plan, **kw)
    reqs = [eng.submit(p, gen_len=g, arrival=t, rid=i)
            for i, (p, g, t) in enumerate(_requests(cfg.vocab_size, n))]
    stats = eng.run()
    counters = {}
    for f in dataclasses.fields(stats):
        if f.name in HOST_TIMES | JAX_ONLY:
            continue
        v = getattr(stats, f.name)
        if f.name == "iter_log":
            v = [{k: x for k, x in r.items()
                  if k not in ITER_LOG_DROP} for r in v]
        counters[f.name] = v
    return dict(
        reqs=[(r.rid, r.state.value, r.tokens.copy(),
               (r.t_admitted, r.t_first_commit, r.t_finished),
               r.n_preempted) for r in reqs],
        stats=counters, vtime=eng.vtime, injected=dict(plan.injected),
        leaked=eng.pool.slots_in_use, conserved=stats.conserved())


def serve_both(spec, n=5, **over):
    """The port's record of a fault scenario, after asserting it equals the
    reference's (pipelined loops; cached per scenario)."""
    kw = dict(BASE, **over)
    jp, tree = _params()
    want = cached(("faults", spec, n, kw), lambda: _serve(
        JEngine, JF, reduced(ARCHS["llada-8b"]), jp, JServe(**kw), spec, n))
    tcfg = treduced(get_config("llada-8b"))
    got = _serve(TEngine, TF, tcfg, from_jax(tree, tcfg, "cpu"),
                 TServe(**kw), spec, n)
    _assert_same(want, got)
    return got


def _assert_same(want, got, skip=()):
    for a, b in zip(want["reqs"], got["reqs"]):
        assert a[0] == b[0] and a[1] == b[1], (a[:2], b[:2])
        assert np.array_equal(a[2], b[2]), a[0]
        assert a[3:] == b[3:], a[0]
    for k, v in want["stats"].items():
        if k not in skip:
            assert got["stats"][k] == v, k
    assert got["vtime"] == want["vtime"]
    assert got["injected"] == want["injected"]


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError):
        TF.FaultEvent("disk", at_iter=1)


@pytest.mark.parametrize("seed", [1, 3, 5, 9])
def test_seeded_plan_matches_reference(seed):
    """The same events, and the same faults handed out when both plans are
    walked through the same iterations and takes."""
    a, b = JF.FaultPlan.seeded(seed), TF.FaultPlan.seeded(seed)
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in b.events]
    for it in range(0, 205):
        a.begin_iteration(it)
        b.begin_iteration(it)
        assert a.take_slow_delay() == b.take_slow_delay()
        assert a.stolen_slots() == b.stolen_slots()
        for stage in ("refresh", "reuse", "decode"):
            assert a.take_dispatch_fault(stage) == \
                b.take_dispatch_fault(stage)
        assert a.take_alloc_fault() == b.take_alloc_fault()
        assert a.blocking() == b.blocking()
    assert a.injected == b.injected


@pytest.mark.parametrize("seed", [1, 3, 5])
def test_chaos_matches_reference(seed):
    """Padded path under a seeded schedule: the reference's ids, times,
    counters and clock; the run degrades but finishes everything and
    leaks no slot."""
    got = serve_both(("seeded", seed))
    assert got["conserved"] and got["leaked"] == []
    assert all(r[1] == State.FINISHED.value for r in got["reqs"])
    st = got["stats"]
    assert st["alloc_fault_iters"] > 0 and st["padded_refresh_calls"] > 0
    assert st["dispatch_retries"] == got["injected"]["dispatch"] > 0


def test_chaos_packed_matches_reference():
    got = serve_both(("seeded", 9), **PACKED)
    assert got["conserved"] and got["leaked"] == []
    assert got["stats"]["packed_refresh_calls"] > 0
    assert got["stats"]["alloc_fault_iters"] > 0


def test_chaos_sync_loop_matches_pipelined():
    """The port's synchronous loop under seed 3's schedule gives the
    pipelined loop's (the reference's) ids, counters and clock; it
    dispatched nothing ahead."""
    want = serve_both(("seeded", 3))
    jp, tree = _params()
    tcfg = treduced(get_config("llada-8b"))
    got = _serve(TEngine, TF, tcfg, from_jax(tree, tcfg, "cpu"),
                 TServe(**BASE, pipeline=False), ("seeded", 3), 5)
    _assert_same(want, got, skip=LOOP_ONLY)
    assert got["stats"]["dispatched_ahead"] == 0
    assert want["stats"]["dispatched_ahead"] > 0


def test_permanent_dispatch_fault_raises_as_the_reference():
    """More consecutive failures than ``fault_retries``: both engines raise
    FaultError on the same attempt, after the same retries and backoff."""
    spec = ("events", (("dispatch", (("at_iter", 1), ("count", 10))),))
    out = []
    jp, tree = _params()
    tcfg = treduced(get_config("llada-8b"))
    for cls, mod, cfg, params in (
            (JEngine, JF, reduced(ARCHS["llada-8b"]), jp),
            (TEngine, TF, tcfg, from_jax(tree, tcfg, "cpu"))):
        kw = {} if cls is JEngine else dict(device="cpu")
        eng = cls(cfg, (JServe if cls is JEngine else TServe)(**BASE),
                  params=params, seed=0, clock="modeled",
                  faults=_plan(mod, spec), **kw)
        eng.submit(np.zeros(16, np.int32), gen_len=8, arrival=0.0, rid=0)
        with pytest.raises(mod.FaultError, match="dispatch fault") as e:
            eng.run()
        out.append((str(e.value), eng.stats.dispatch_retries, eng.vtime))
    assert out[0] == out[1]
    assert out[1][1] == BASE.get("fault_retries", 3) - 1


def test_alloc_fault_defers_admission_as_the_reference():
    got = serve_both(("events", (("alloc", (("at_iter", 1),
                                            ("count", 3))),)))
    assert got["stats"]["alloc_fault_iters"] >= 1
    assert got["injected"]["alloc"] == 3 and got["conserved"]


def test_mem_steal_recovers_as_the_reference():
    """Every free slot stolen for five iterations: admission waits it out
    (or preempts to reclaim) and everything finishes."""
    got = serve_both(("events", (("mem", (("at_iter", 2),
                                          ("count", BASE["max_slots"]),
                                          ("duration", 5))),)))
    assert got["injected"]["mem"] == 1
    assert got["conserved"] and got["leaked"] == []
    assert all(r[1] == State.FINISHED.value for r in got["reqs"])


def test_slow_delay_charged_as_the_reference():
    got = serve_both(("events", (("slow", (("at_iter", 1),
                                           ("delay_s", 0.5))),)), n=2)
    assert got["stats"]["slow_fault_s"] == pytest.approx(0.5)
    assert got["vtime"] >= 0.5
