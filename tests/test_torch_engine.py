"""The slice as a whole: the JAX engine and the port's engine serve the same
requests on the same weights (reduced llada-8b, float32), the dllm-serve
profile with the kernel paths on (``use_flash_kernel=True``,
``logit_mode="fused"``), the synchronous loop and the modeled clock; the
port runs on the CPU, i.e. on its kernels' plain versions.

Exact: every committed token id, every EngineStats counter and the modeled
clock. The only fields left out are host wall-clock timings and the JAX
compile counters, which measure the host and XLA, not the serving.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import system_profiles as jprofiles
from repro.core.engine import Engine as JEngine
from repro.launch.serve import run_serve as jrun_serve
from repro.models import backbone as JBB
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.baselines import system_profiles as tprofiles
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.request import State
from repro_torch.launch.serve import run_serve as trun_serve
from repro_torch.params import from_jax

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


def test_engine_matches_reference_exactly():
    jcfg = reduced(ARCHS["llada-8b"])
    tcfg = treduced(get_config("llada-8b"))
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(3))
    je = JEngine(jcfg, _serve(JServe, jprofiles), params=jp, clock="modeled")
    te = TEngine(tcfg, _serve(TServe, tprofiles),
                 params=from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"),
                 clock="modeled", device="cpu")
    jreqs, treqs = [], []
    for i, (p, g, t) in enumerate(_requests(jcfg.vocab_size)):
        jreqs.append(je.submit(p, gen_len=g, arrival=t, rid=i))
        treqs.append(te.submit(p, gen_len=g, arrival=t, rid=i))
    js, ts = je.run(), te.run()
    assert all(r.state == State.FINISHED for r in treqs)
    assert ts.reuse_steps > 0 and ts.deferred_steps > 0
    for a, b in zip(jreqs, treqs):
        assert np.array_equal(a.tokens, b.tokens), a.rid
        assert (a.t_admitted, a.t_first_commit, a.t_finished) == \
            (b.t_admitted, b.t_first_commit, b.t_finished)
    assert je.vtime == te.vtime
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


@pytest.mark.parametrize("workload", ["burst", "livebench"])
def test_run_serve_json_matches_reference(workload):
    kw = dict(use_reduced=True, seed=1, kernels=True, clock="modeled",
              size_by_profiler=False, pipeline=False, max_seq_len=128,
              max_num_batched_tokens=384, max_slots=6)
    want = jrun_serve("llada-8b", "dllm-serve", workload, 4.0, 4, **kw)
    got = trun_serve("llada-8b", "dllm-serve", workload, 4.0, 4,
                     device="cpu", **kw)
    assert set(got) == set(want)
    assert got["n_finished"] == 4
    skip = HOST_TIMES | JAX_ONLY | {"warmup_s", "wall_clock_s", "wall_tok_s",
                                    "overlap_frac", "compiles_post_warmup"}
    for k in sorted(set(want) - skip):
        assert got[k] == want[k], k


def test_unported_engine_options_raise():
    tcfg = treduced(get_config("llada-8b"))
    base = _serve(TServe, tprofiles)
    for bad in (dict(pipeline=True), dict(mesh_shape=(1, 2)),
                dict(prefix_sharing=True), dict(kv_quant="int8"),
                dict(varlen_pack=False), dict(use_flash_kernel=False)):
        with pytest.raises(NotImplementedError):
            TEngine(tcfg, dataclasses.replace(base, **bad), device="cpu")
    with pytest.raises(NotImplementedError):
        trun_serve("llada-8b", "dllm-serve", "burst", 4.0, 2,
                   size_by_profiler=True, device="cpu", kernels=True)


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
