"""The reference's admission and lifecycle scenarios
(``tests/test_robustness.py``, no faults) served by both engines on the same
weights (reduced, float32, the modeled clock, the pipelined loop): the
bounded queue's reject and evict policies, deadline shedding, an overload
burst, preempt-and-requeue on the padded and packed paths of an attention
and an SSM arch, the per-request preemption cap, and no knobs at all.

Exact: each request's state, outcome, tokens, times and preemption
counts, every EngineStats counter and ``vtime``. A preempted request's
rollback and the pipelined loop's discard of its in-flight commit are
reached here. The launcher's four admission flags
(``--queue-cap/--queue-policy/--deadline/--preempt-starvation``) reach
``run_serve`` and give the reference launcher's JSON.
"""
import dataclasses
import json
import sys

import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import numpy as np
import pytest

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core.engine import Engine as JEngine
from repro.launch import serve as jlaunch
from repro.models import backbone as JBB
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.engine import Engine as TEngine
from repro_torch.launch import serve as tlaunch
from repro_torch.params import from_jax
from test_torch_engine import HOST_TIMES, JAX_ONLY, PORT_ONLY
from torch_testing import cached

BASE = dict(max_num_batched_tokens=512, max_num_logits=64, block_size=8,
            steps_per_block=8, max_seq_len=128, max_slots=8,
            max_refresh_per_iter=2, selection="head", scheduler="phase",
            logit_mode="chunked")


def _params(arch, seed):
    def make():
        jcfg = reduced(ARCHS[arch])
        jp = JBB.init_params(jcfg, jax.random.PRNGKey(seed))
        return jp, jax.tree.map(np.asarray, jp)
    return cached(("params", arch, seed), make)


def _record(reqs, stats, vtime):
    rows = [dict(rid=r.rid, state=r.state.value,
                 outcome=r.outcome.value if r.outcome else None,
                 tokens=None if r.tokens is None else r.tokens.copy(),
                 times=(r.t_admitted, r.t_first_commit, r.t_finished),
                 n_preempted=r.n_preempted,
                 recomputed=r.recomputed_tokens) for r in reqs]
    counters = {}
    for f in dataclasses.fields(stats):
        if f.name in HOST_TIMES | JAX_ONLY | {"wall_time"}:
            continue
        v = getattr(stats, f.name)
        if f.name == "iter_log":
            v = [{k: x for k, x in r.items()
                  if k not in ("plan_s", "fill_s", "sync_s")} for r in v]
        counters[f.name] = v
    return dict(reqs=rows, stats=counters, vtime=vtime)


def _run(engine_cls, serve, cfg, params, requests, seed):
    eng = engine_cls(cfg, serve, params=params, seed=seed, clock="modeled",
                     **({} if engine_cls is JEngine else dict(device="cpu")))
    reqs = [eng.submit(p, gen_len=g, arrival=t, rid=i, deadline=d)
            for i, (p, g, t, d) in enumerate(requests)]
    at_submit = [(r.state.value, r.outcome.value if r.outcome else None)
                 for r in reqs]
    stats = eng.run()
    out = _record(reqs, stats, eng.vtime)
    out["at_submit"] = at_submit
    out["conserved"] = stats.conserved()
    return out


def serve_both(requests, arch="llada-8b", seed=0, **over):
    """The port's record of a scenario, after asserting it equals the
    reference's (cached per scenario)."""
    kw = dict(BASE, **over)
    jp, tree = _params(arch, seed)
    want = cached(("serve", arch, seed, kw, requests), lambda: _run(
        JEngine, JServe(**kw), reduced(ARCHS[arch]), jp, requests, seed))
    tcfg = treduced(get_config(arch))
    got = _run(TEngine, TServe(**kw), tcfg, from_jax(tree, tcfg, "cpu"),
               requests, seed)
    assert got["at_submit"] == want["at_submit"]
    for a, b in zip(want["reqs"], got["reqs"]):
        ta, tb = a["tokens"], b["tokens"]
        assert (ta is None) == (tb is None), a["rid"]
        assert ta is None or np.array_equal(ta, tb), a["rid"]
        assert {k: v for k, v in a.items() if k != "tokens"} == \
            {k: v for k, v in b.items() if k != "tokens"}
    for k, v in want["stats"].items():
        assert got["stats"][k] == v, k
    assert got["vtime"] == want["vtime"] and got["conserved"]
    return got


def _zeros(n, g, t=0.0, d=float("inf")):
    return (np.zeros(n, np.int32), g, t, d)


@pytest.mark.parametrize("policy", ["reject", "evict"])
def test_queue_cap_matches_reference(policy):
    """Three future arrivals into a queue of two: the third is rejected
    (``reject``) or the oldest waiter is shed (``evict``)."""
    got = serve_both([_zeros(8, 8, 1.0)] * 3, queue_cap=2,
                     queue_policy=policy)
    st = got["stats"]
    if policy == "reject":
        assert got["at_submit"][2] == ("rejected", "rejected_queue_full")
        assert st["rejected_queue_full"] == 1 and st["finished"] == 2
    else:
        assert got["at_submit"][0] == ("shed", "shed_queue")
        assert st["shed_queue"] == 1 and st["finished"] == 2


@pytest.mark.parametrize("expired", [True, False])
def test_deadline_matches_reference(expired):
    """One slot held by a long request: a waiter whose deadline passes in
    the queue is shed; one whose deadline is far is served."""
    if expired:
        got = serve_both([_zeros(16, 32), _zeros(16, 8, d=1e-6)],
                         max_slots=1)
        assert [r["outcome"] for r in got["reqs"]] == ["finished",
                                                       "shed_deadline"]
        assert got["stats"]["shed_deadline"] == 1
    else:
        got = serve_both([_zeros(16, 8, d=1e9)])
        assert got["reqs"][0]["outcome"] == "finished"
        assert got["stats"]["shed_deadline"] == 0


def _preempt_requests(vocab):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab - 1, 20), 24, 0.0, float("inf"))
            for _ in range(3)]


@pytest.mark.parametrize("arch", ["llada-8b", "mamba2-130m"])
@pytest.mark.parametrize("varlen", [False, True])
def test_preemption_matches_reference(arch, varlen):
    """Three requests through two slots: the starved waiter preempts the
    youngest Reuse resident, whose block rolls back and is recomputed by a
    normal Refresh. The port equals the reference, and its outputs equal
    its own unpreempted run's, token for token."""
    kw = dict(max_slots=2, max_refresh_per_iter=2, varlen_pack=varlen,
              token_bucket=64)
    reqs = _preempt_requests(reduced(ARCHS[arch]).vocab_size)
    got = serve_both(reqs, arch=arch, preempt_starvation_s=0.02, **kw)
    assert got["stats"]["preemptions"] > 0
    assert any(r["n_preempted"] for r in got["reqs"])
    jp, tree = _params(arch, 0)
    tcfg = treduced(get_config(arch))
    base = _run(TEngine, TServe(**dict(BASE, **kw)), tcfg,
                from_jax(tree, tcfg, "cpu"), reqs, 0)
    assert base["stats"]["preemptions"] == 0
    for a, b in zip(base["reqs"], got["reqs"]):
        assert a["state"] == b["state"] == "finished"
        assert np.array_equal(a["tokens"], b["tokens"]), a["rid"]


def test_preemption_capped_per_request_matches_reference():
    got = serve_both([_zeros(16, 24)] * 4, max_slots=2,
                     preempt_starvation_s=0.01, max_preemptions=1)
    assert got["stats"]["preemptions"] > 0
    assert all(r["state"] == "finished" and r["n_preempted"] <= 1
               for r in got["reqs"])


def test_no_robustness_knobs_matches_reference():
    """The default knobs: no preemption, shed or rejection, the reference's
    output, and the same output from a second fresh engine."""
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, 255, 16), 16, 0.0, float("inf"))
            for _ in range(4)]
    got = serve_both(reqs, seed=7)
    again = serve_both(reqs, seed=7)
    st = got["stats"]
    assert st["preemptions"] == st["shed_deadline"] == st["shed_queue"] == 0
    assert st["rejected_queue_full"] == st["rejected_oversized"] == 0
    for a, b in zip(got["reqs"], again["reqs"]):
        assert np.array_equal(a["tokens"], b["tokens"])


FLAGS = ["--queue-cap", "4", "--queue-policy", "evict", "--deadline", "3.0",
         "--preempt-starvation", "0.5"]


def test_cli_admission_flags_reach_run_serve(monkeypatch):
    """Both launchers parse the four flags into the same ``run_serve``
    keywords (the call itself stubbed)."""
    seen = {}

    def stub(name):
        def run_serve(*args, **kw):
            seen[name] = kw
            return {}
        return run_serve
    for name, mod in (("ref", jlaunch), ("port", tlaunch)):
        monkeypatch.setattr(mod, "run_serve", stub(name))
        monkeypatch.setattr(sys, "argv", ["serve", *FLAGS, "--mesh", "none"]
                            if name == "ref" else ["serve", *FLAGS])
        mod.main()
    keys = ("queue_cap", "queue_policy", "deadline_slack",
            "preempt_starvation_s")
    want = dict(queue_cap=4, queue_policy="evict", deadline_slack=3.0,
                preempt_starvation_s=0.5)
    assert {k: seen["ref"][k] for k in keys} == want
    assert {k: seen["port"][k] for k in keys} == want


def test_overload_burst_matches_reference(capsys, monkeypatch):
    """The reference's overload scenario (a burst far past the admissible
    rate, a queue cap, deadlines and preemption) through the port's CLI on
    the CPU, held to the reference launcher with the same keywords: every
    request ends in a structured outcome, some are shed, and the JSON is
    the reference's."""
    kw = dict(seed=0, queue_cap=4, queue_policy="evict", deadline_slack=3.0,
              preempt_starvation_s=0.5)
    want = jlaunch.run_serve("llada-8b", "dllm-serve", "burst", 40.0, 24,
                             **kw)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "llada-8b", "--system", "dllm-serve",
        "--workload", "burst", "--rps", "40", "--n", "24", "--device", "cpu",
        *FLAGS])
    tlaunch.main()
    out = capsys.readouterr().out
    got = json.loads(out[out.index("{"):])
    assert got["n_submitted"] == 24 and got["n_shed"] > 0
    assert got["n_finished"] + got["n_shed"] + got["n_rejected"] == 24
    assert got["goodput_tok_s"] <= got["throughput_tok_s"] + 1e-9
    skip = HOST_TIMES | JAX_ONLY | {"warmup_s", "wall_clock_s", "wall_tok_s",
                                    "overlap_frac", "compiles_post_warmup"}
    assert set(got) == set(want) | PORT_ONLY
    for k in sorted(set(want) - skip):
        assert got[k] == want[k], k
