"""The port's prefix sharing and int8 KV slots against the reference's
(``tests/test_kv_share.py``), on the CPU.

* Content keys: ``block_chain_key`` / ``content_key`` give the reference's
  bytes (frontend geometry included).
* The share ledger: random write/release interleavings drive the port's
  and the reference's ledgers side by side; every return value (the
  ``(do_write, promote)`` pairs), the owner map, the counters and the
  invariant suite agree after every operation.
* The port's pool: dedup, copy-on-write on divergence and on free, and
  double-free, as the reference's pool test.
* int8: ``quantize_slot_leaves`` gives the reference's codes and scales
  exactly (float32 and bfloat16 caches, dense and hybrid trees), the
  dequantized values too, and the round trip stays inside
  ``roundtrip_bound``.
* ``plan_memory`` / ``size_slots`` with a share factor and int8 slots,
  field for field.
* End to end on the shared-prefix trace (reduced, float32, the modeled
  clock, starvation preemption on): sharing on llada-8b and mamba2-130m,
  packed and padded; int8 packed; sharing with int8; exact ids, request
  times, every EngineStats counter (``shared_hits``,
  ``shared_cow_promotes``, ``phys_slots_peak`` among them) and ``vtime``;
  at the end the int8 pool's scales agree with the reference's to rtol
  1e-6 and its codes to one step at rounding boundaries (``_same_pool``).
  The
  launcher's ``--sharing --kv-quant int8 --faults`` JSON equals the
  reference's.
"""
import dataclasses

import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import given, settings, st

from repro.configs import ARCHS, get_config as jget_config, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core import share_ledger as JL
from repro.core.baselines import size_slots as jsize_slots
from repro.core.budgeting import plan_memory as jplan_memory
from repro.core.engine import Engine as JEngine
from repro.data.workloads import PrefixSpec, make_trace, trace_prompts
from repro.kernels import kv_quant as JQ
from repro.launch.serve import run_serve as jrun_serve
from repro.models import backbone as JBB
from repro.models.hybrid import HybridCache as JHybridCache
from repro.models.sparse_select import PackedKV as JPackedKV
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import budgeting as TB
from repro_torch.core import share_ledger as TL
from repro_torch.core.baselines import size_slots
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.kv_pool import KVPool, tree_leaves
from repro_torch.data.workloads import prefix_share_factor
from repro_torch.kernels import kv_quant as TQ
from repro_torch.kernels import ops as OPS
from repro_torch.launch.serve import run_serve as trun_serve
from repro_torch.models.hybrid import HybridCache
from repro_torch.models.sparse_select import PackedKV
from repro_torch.params import from_jax
from test_torch_engine import HOST_TIMES, JAX_ONLY, PORT_ONLY
from torch_testing import ITER_LOG_DROP, cached

# the reference's end-to-end geometry (tests/test_kv_share.py SERVE)
SERVE = dict(max_num_batched_tokens=512, max_num_logits=64, block_size=8,
             steps_per_block=8, max_seq_len=128, max_slots=6,
             max_refresh_per_iter=2, selection="head", scheduler="phase",
             logit_mode="chunked", token_bucket=64,
             preempt_starvation_s=0.05)


# ---------------------------------------------------------------------------
# content keys and the ledger
# ---------------------------------------------------------------------------

def test_content_keys_match_reference():
    rng = np.random.default_rng(0)
    for n, bs in ((64, 8), (37, 8), (128, 16), (5, 1)):
        t = rng.integers(0, 1000, n).astype(np.int32)
        assert TL.block_chain_key(t, bs) == JL.block_chain_key(t, bs)
        fe = rng.standard_normal((3, 4)).astype(np.float32)
        for args in ((n, 0, None), (n - 1, 8, None), (n, 8, fe)):
            assert TL.content_key(t, bs, *args) == \
                JL.content_key(t, bs, *args)
    t = np.arange(64, dtype=np.int32)
    k0 = TL.content_key(t, 8, 64, 32, None)
    assert TL.content_key(t, 8, 60, 32, None) != k0      # total_len
    assert TL.content_key(t, 8, 64, 40, None) != k0      # block_start
    fe = np.ones((2, 4), np.float32)
    assert TL.content_key(t, 8, 64, 32, fe * 2) != \
        TL.content_key(t, 8, 64, 32, fe)                 # frontend content


def _ledger_state(led):
    return (dict(led.owner_of), {o: set(r) for o, r in led.referrers.items()},
            dict(led.key_of), led.hits, led.cow_promotes, led.phys_slots)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10**9), n_slots=st.integers(2, 8),
       n_keys=st.integers(1, 5))
def test_ledger_interleavings_match_reference(seed, n_slots, n_keys):
    rng = np.random.default_rng(seed)
    a, b = JL.ShareLedger(), TL.ShareLedger()
    for _ in range(150):
        slot = int(rng.integers(0, n_slots))
        if rng.integers(0, 3) < 2:
            key = bytes([int(rng.integers(0, n_keys))])
            assert a.record_write(slot, key) == b.record_write(slot, key)
        else:
            assert a.release(slot) == b.release(slot)
        b.check()
        assert _ledger_state(a) == _ledger_state(b)
        assert all(a.refcount(s) == b.refcount(s) >= 0
                   and a.resolve(s) == b.resolve(s)
                   and a.is_shared_owner(s) == b.is_shared_owner(s)
                   for s in range(n_slots))


def _tiny(val: float):
    return {"kv": torch.full((2, 1, 3), val)}


def _row(pool, slot):
    return pool.gather(pool.resolve([slot]))["kv"][:, 0]


def test_pool_dedup_and_copy_on_write():
    """The reference's pool sequence on the port's pool: a dedup hit shares
    one row, a divergent owner's bytes survive on its referrer, a freed
    owner's bytes too, and everything drains."""
    pool = KVPool(4, "cpu", sharing=True)
    for s in (0, 1, 2):
        pool.take(s)
    pool.write_shared([0], _tiny(1.0), [b"A"])
    pool.write_shared([1], _tiny(1.0), [b"A"])
    pool.write_shared([2], _tiny(2.0), [b"B"])
    assert pool.ledger.hits == 1 and pool.phys_slots_in_use == 2
    assert pool.phys_peak == 2
    assert bool((_row(pool, 1) == 1.0).all())
    pool.write_shared([0], _tiny(3.0), [b"C"])          # owner diverges
    assert pool.ledger.cow_promotes == 1
    assert bool((_row(pool, 0) == 3.0).all())
    assert bool((_row(pool, 1) == 1.0).all()), "referrer lost its bytes"
    pool.write_shared([0], _tiny(2.0), [b"B"])          # join slot 2's B
    assert pool.shared_refs(2) == 2
    pool.free([2])                                      # owner of B dies
    assert bool((_row(pool, 0) == 2.0).all()), "promote on free tore"
    with pytest.raises(RuntimeError, match="double-free"):
        pool.free([2])
    pool.free([0, 1])
    assert pool.phys_slots_in_use == 0 and pool.slots_in_use == []
    pool.ledger.check()
    with pytest.raises(RuntimeError, match="sharing"):
        KVPool(2, "cpu").write_shared([0], _tiny(1.0), [b"A"])
    with pytest.raises(ValueError):
        KVPool(2, "cpu", kv_quant="int4")


# ---------------------------------------------------------------------------
# int8 storage
# ---------------------------------------------------------------------------

def _caches(dtype, hybrid):
    """The same random cache, a reference tree and a port tree: per-slot
    ranges over four decades, [L, B, K, R, dh] keys and values."""
    rng = np.random.default_rng(7)
    L, B, K, R, dh = 2, 5, 3, 4, 8
    scale = 10.0 ** rng.uniform(-2, 2, (L, B))
    k = rng.standard_normal((L, B, K, R, dh)) * scale[..., None, None, None]
    v = rng.standard_normal((L, B, K, R, dh)) * scale[..., None, None, None]
    pos = rng.integers(0, 100, (L, B, K, R)).astype(np.int32)
    valid = rng.integers(0, 2, (L, B, K, R)).astype(bool)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    tk = torch.from_numpy(np.asarray(jk.astype(jnp.float32))).to(dtype)
    tv = torch.from_numpy(np.asarray(jv.astype(jnp.float32))).to(dtype)
    jkv = JPackedKV(k=jk, v=jv, pos=jnp.asarray(pos), valid=jnp.asarray(valid))
    tkv = PackedKV(k=tk, v=tv, pos=torch.from_numpy(pos),
                   valid=torch.from_numpy(valid))
    if not hybrid:
        return jkv, tkv
    state = rng.standard_normal((3, B, 2, 4, 4)).astype(np.float32)
    conv = rng.standard_normal((3, B, 3, 6)).astype(np.float32)
    return (JHybridCache(ssm_state=jnp.asarray(state), conv=jnp.asarray(conv),
                         kv=jkv),
            HybridCache(ssm_state=torch.from_numpy(state),
                        conv=torch.from_numpy(conv), kv=tkv))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_codes_and_scales_match_reference(dtype, hybrid):
    jc, tc = _caches(dtype, hybrid)
    jq, jsc = JQ.quantize_slot_leaves(jc)
    tq, tsc = TQ.quantize_slot_leaves(tc)
    assert TQ.quant_leaf_flags(tc) == JQ.quant_leaf_flags(jc)
    assert set(tsc) == set(jsc) and len(tsc) == 2
    for k in jsc:
        assert np.array_equal(tsc[k].numpy(), np.asarray(jsc[k])), k
    for a, b in zip(jax.tree.leaves(jq), tree_leaves(tq)):
        assert b.dtype == {jnp.int8: torch.int8}.get(a.dtype, b.dtype)
        assert np.array_equal(_np(a), _np(b))
    jdq = JQ.dequantize_slot_leaves(jq, jsc, {k: a.dtype for k, a in zip(
        jsc, [jax.tree.leaves(jc)[int(k)] for k in jsc])})
    tdq = OPS.dequantize_gathered({"data": tq, "scale": tsc}, "int8",
                                  {k: dtype for k in tsc})
    for a, b in zip(jax.tree.leaves(jdq), tree_leaves(tdq)):
        assert np.array_equal(_np(a), _np(b))
    assert OPS.dequantize_gathered(tc, "none", None) is tc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_roundtrip_inside_bound(dtype):
    _, tc = _caches(dtype, False)
    q, sc = TQ.quantize_slot_leaves(tc)
    assert q.k.dtype == torch.int8 and q.pos.dtype == torch.int32
    dq = TQ.dequantize_slot_leaves(q, sc, {k: dtype for k in sc})
    x = tc.k.float()
    absmax = x.abs().amax(dim=(2, 3, 4)).numpy()
    err = (dq.k.float() - x).abs().amax(dim=(2, 3, 4)).numpy()
    bound = np.vectorize(lambda a: TQ.roundtrip_bound(a, dtype))(absmax)
    assert np.all(err <= bound + 1e-9), (err / bound).max()
    assert torch.equal(dq.pos, tc.pos) and torch.equal(dq.valid, tc.valid)


def test_int8_pool_round_trips_through_gather():
    pool = KVPool(3, "cpu", kv_quant="int8")
    kv = torch.linspace(-2, 2, 2 * 1 * 4 * 2 * 2).reshape(2, 1, 4, 2, 2)
    cache = PackedKV(k=kv, v=kv * 0.5, pos=torch.zeros((2, 1, 4, 2),
                                                       dtype=torch.int32),
                     valid=torch.ones((2, 1, 4, 2), dtype=torch.bool))
    pool.take(1)
    pool.write([1], cache)
    g = pool.gather([1])
    assert set(g) == {"data", "scale"} and g["data"].k.dtype == torch.int8
    dq = OPS.dequantize_gathered(g, "int8", pool.gathered_dtypes)
    assert (dq.k - kv).abs().max() <= TQ.roundtrip_bound(2.0, torch.float32)
    assert torch.equal(dq.pos, cache.pos)


# ---------------------------------------------------------------------------
# the profiler's multipliers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llada-8b", "zamba2-7b", "mamba2-130m",
                                  "internvl2-76b"])
def test_plan_memory_multipliers_match_reference(arch):
    trace = make_trace("shared-prefix", 64, rps=4.0, seed=0,
                       prefix=PrefixSpec(n_prefixes=4, prefix_len=64))
    share = prefix_share_factor(trace)
    from repro.data.workloads import prefix_share_factor as jshare
    assert share == jshare(trace) >= 2.0
    geo = dict(max_num_batched_tokens=4000, max_num_logits=2048,
               max_seq_len=2048, max_slots=4096, logit_mode="chunked")
    for sharing, quant in ((True, "none"), (False, "int8"), (True, "int8")):
        for hbm in (24 << 30, 80 << 30):
            kw = dict(geo, prefix_sharing=sharing, kv_quant=quant)
            want = jplan_memory(jget_config(arch), JServe(**kw), hbm,
                                share_factor=share)
            got = TB.plan_memory(get_config(arch), TServe(**kw), hbm,
                                 share_factor=share)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.summary() == want.summary()
            assert TB.kv_slot_bytes(get_config(arch), TServe(**kw)) == \
                want.slot_bytes
            assert size_slots(get_config(arch), TServe(**kw), hbm,
                              share_factor=share).max_slots == \
                jsize_slots(jget_config(arch), JServe(**kw), hbm,
                            share_factor=share).max_slots


# ---------------------------------------------------------------------------
# end to end against the reference
# ---------------------------------------------------------------------------

def _params(arch):
    def make():
        jcfg = reduced(ARCHS[arch])
        jp = JBB.init_params(jcfg, jax.random.PRNGKey(0))
        return jp, jax.tree.map(np.asarray, jp)
    return cached(("share-params", arch), make)


def _serve(engine_cls, cfg, params, serve, n=8, seed=3):
    kw = {} if engine_cls is JEngine else dict(device="cpu")
    eng = engine_cls(cfg, serve, params=params, seed=0, clock="modeled",
                     **kw)
    trace = make_trace("shared-prefix", n, rps=8.0, seed=seed,
                       prefix=PrefixSpec(n_prefixes=3, prefix_len=24))
    prompts = trace_prompts(trace, cfg.vocab_size, seed=seed)
    # arrival 0 for every request: co-resident twins are what the ledger
    # dedups, and with fewer slots than requests preemption runs too
    reqs = [eng.submit(p, gen_len=16, arrival=0.0, rid=i)
            for i, p in enumerate(prompts)]
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
    if isinstance(eng.pool.cache, dict) and "scale" in eng.pool.cache:
        pool = [np.asarray(x) for x in jax.tree.leaves(eng.pool.cache)] \
            if engine_cls is JEngine else \
            [t.numpy() for t in tree_leaves(eng.pool.cache)]
    else:
        pool = None
    return dict(reqs=[(r.rid, r.state.value, r.tokens.copy(),
                       (r.t_admitted, r.t_first_commit, r.t_finished),
                       r.n_preempted) for r in reqs],
                stats=counters, vtime=eng.vtime, pool=pool, eng=eng)


def serve_both(arch, **over):
    kw = dict(SERVE, **over)
    jp, tree = _params(arch)

    def reference():
        out = _serve(JEngine, reduced(ARCHS[arch]), jp, JServe(**kw))
        out.pop("eng")
        return out
    want = cached(("share", arch, kw), reference)
    tcfg = treduced(get_config(arch))
    got = _serve(TEngine, tcfg, from_jax(tree, tcfg, "cpu"), TServe(**kw))
    for a, b in zip(want["reqs"], got["reqs"]):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2]), a[0]
        assert a[3:] == b[3:], a[0]
    for k, v in want["stats"].items():
        assert got["stats"][k] == v, k
    assert got["vtime"] == want["vtime"]
    assert got["stats"]["finished"] == 8
    return got


def _drained(eng):
    assert eng.pool.slots_in_use == [] and eng.pool.phys_slots_in_use == 0
    eng.pool.ledger.check()


@pytest.mark.parametrize("varlen", [True, False])
@pytest.mark.parametrize("arch", ["llada-8b", "mamba2-130m"])
def test_e2e_sharing_matches_reference(arch, varlen):
    got = serve_both(arch, varlen_pack=varlen, prefix_sharing=True)
    st = got["stats"]
    assert st["shared_hits"] > 0 and st["shared_cow_promotes"] > 0
    assert 0 < st["phys_slots_peak"] <= SERVE["max_slots"]
    assert (st["packed_refresh_calls"] > 0) == varlen
    _drained(got["eng"])


def _same_pool(want, got):
    """The final int8 pools. The quantizer is the reference's exactly on
    the same inputs (``test_int8_codes_and_scales_match_reference``), but
    the float32 caches it quantizes agree between the packages to a few
    ulps only (every parity test holds caches allclose), and the
    reference's ulps vary between processes. So the scales agree to rtol
    1e-6, and a code may differ by one where its value lies within ulps of
    a rounding boundary: at most one code in 10,000. Positions and
    validity are exact."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        elif a.dtype == np.int8:
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            assert d.max() <= 1 and (d > 0).sum() * 10_000 <= d.size, \
                ((d > 0).sum(), d.size)
        else:
            assert np.array_equal(a, b)


def test_e2e_int8_matches_reference():
    """int8 slots on the packed path: the reference's ids and counters, and
    at the end the reference's pool, int8 codes and float32 scales alike."""
    got = serve_both("llada-8b", varlen_pack=True, kv_quant="int8")
    want = cached(("share", "llada-8b", dict(SERVE, varlen_pack=True,
                                             kv_quant="int8")), None)
    assert got["eng"].pool.cache["data"].k.dtype == torch.int8
    _same_pool(want["pool"], got["pool"])


def test_e2e_sharing_with_int8_matches_reference():
    got = serve_both("llada-8b", varlen_pack=True, prefix_sharing=True,
                     kv_quant="int8")
    want = cached(("share", "llada-8b", dict(
        SERVE, varlen_pack=True, prefix_sharing=True, kv_quant="int8")),
        None)
    assert got["stats"]["shared_hits"] > 0
    _same_pool(want["pool"], got["pool"])
    _drained(got["eng"])


def test_run_serve_flags_match_reference():
    """``run_serve`` with sharing, int8 slots and a fault plan on the
    shared-prefix trace (the launcher's ``--sharing --kv-quant int8
    --faults 1``): every key of the reference's JSON, the plan's share
    factor and slots among them. At the engine tests' geometry (S 128,
    six slots), where the reference compiles fewer buckets than at the
    launcher's."""
    kw = dict(prefix_sharing=True, kv_quant="int8", fault_seed=1,
              max_seq_len=128, max_slots=6, max_num_batched_tokens=512,
              max_num_logits=64)
    want = jrun_serve("llada-8b", "dllm-serve", "shared-prefix", 8.0, 4,
                      **kw)
    got = trun_serve("llada-8b", "dllm-serve", "shared-prefix", 8.0, 4,
                     device="cpu", **kw)
    assert set(got) == set(want) | PORT_ONLY
    assert got["share_factor"] > 1.0 and got["kv_quant"] == "int8"
    assert got["shared_hits"] > 0 and got["n_finished"] == 4
    host = {"warmup_s", "wall_clock_s", "wall_tok_s", "host_plan_s",
            "host_fill_s", "sync_wait_s", "overlapped_host_s",
            "overlap_frac", "compile_counts", "compiles_warmup",
            "compiles_post_warmup"}
    for k in sorted(set(want) - host):
        assert got[k] == want[k], k
    assert got["device_bill"]["fits"] and \
        got["device_bill"]["resized_from"] is None


def code_differences(seeds=range(5)):
    """The final int8 pools of the port and the reference, served on the
    shared-prefix trace of each seed (int8 packed, then with sharing):
    per case, the largest code difference, the codes that differ and the
    largest relative scale difference. ``_same_pool``'s bounds are set
    from what this shows."""
    jp, tree = _params("llada-8b")
    tcfg = treduced(get_config("llada-8b"))
    tp = from_jax(tree, tcfg, "cpu")
    for over in (dict(kv_quant="int8"),
                 dict(kv_quant="int8", prefix_sharing=True)):
        kw = dict(SERVE, varlen_pack=True, **over)
        for seed in seeds:
            want = _serve(JEngine, reduced(ARCHS["llada-8b"]), jp,
                          JServe(**kw), seed=seed)["pool"]
            got = _serve(TEngine, tcfg, tp, TServe(**kw), seed=seed)["pool"]
            codes = [(np.abs(a.astype(np.int16) - b.astype(np.int16)))
                     for a, b in zip(want, got) if a.dtype == np.int8]
            rel = max(float(np.max(np.abs(b - a) / np.maximum(np.abs(a),
                                                               1e-30)))
                      for a, b in zip(want, got) if a.dtype == np.float32)
            print(dict(case=sorted(over), seed=seed,
                       max_code_diff=int(max(d.max() for d in codes)),
                       codes_differing=int(sum((d > 0).sum() for d in codes)),
                       codes=int(sum(d.size for d in codes)),
                       max_scale_rel_diff=rel), flush=True)


if __name__ == "__main__":
    # PYTHONPATH=src:tests python tests/test_torch_kv_share.py
    code_differences()
