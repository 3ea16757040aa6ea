"""The port's hybrid family (zamba2-7b: a Mamba2 stack and one shared,
causal attention+MLP block) against ``repro`` on the same weights and
inputs, reduced (3 Mamba layers, the shared block after every 2, so one
group and a tail of one), float32. The JAX side runs its Pallas kernels in
interpret mode; the port runs on the CPU, i.e. on the plain versions.

Tolerances: 1e-4 on hidden states and retained keys/values (magnitude ~1),
1e-5 on captured states and conv histories (~1e-2); retained positions and
their validity, ids, every EngineStats counter and the modeled clock exact.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import backbone as JBB
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.core.kv_pool import KVPool
from repro_torch.kernels import build
from repro_torch.models import backbone as TBB
from repro_torch.models import hybrid as HY
from repro_torch.models.sparse_select import PackedKV
from repro_torch.params import from_jax
from test_torch_ssm import (LENS, engines_match, refresh_both, reuse_both,
                            run_serve_matches)

ARCH = "zamba2-7b"


def test_serve_refresh_and_reuse_packed_match_reference():
    jcfg, tcfg, jp, tp, ref, out = refresh_both(ARCH)
    n = len(LENS)
    assert isinstance(out.cache, HY.HybridCache)
    np.testing.assert_allclose(out.block_hidden.numpy()[:n],
                               np.asarray(ref.block_hidden)[:n], atol=1e-4)
    rc = jax.tree.map(np.asarray, ref.cache)
    for got, want in ((out.cache.ssm_state, rc.ssm_state),
                      (out.cache.conv, rc.conv)):
        np.testing.assert_allclose(got.numpy()[:, :n], want[:, :n], atol=1e-5)
    kv = [t.numpy()[:, :n] for t in out.cache.kv]
    assert kv[2].shape[0] == 1                      # one shared invocation
    assert np.array_equal(kv[2], rc.kv.pos[:, :n])
    assert np.array_equal(kv[3], rc.kv.valid[:, :n])
    ok = rc.kv.valid[:, :n]
    assert ok.sum() > 0
    for got, want in ((kv[0], rc.kv.k), (kv[1], rc.kv.v)):
        np.testing.assert_allclose(got[ok], want[:, :n][ok], atol=1e-4)
    h, h_ref = reuse_both(jcfg, tcfg, jp, tp, ref)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-4)


def test_engine_matches_reference_exactly():
    ts = engines_match(ARCH)
    assert ts.packed_refresh_calls > 0 and ts.padded_refresh_calls == 0
    for name in ("ssm_segment_scan", "flash_varlen", "flash_varlen_cross",
                 "head_score_varlen", "fused_logit_argmax"):
        assert build.COUNTERS[name].plain_calls > 0, name


def test_run_serve_json_matches_reference():
    run_serve_matches(ARCH)


def test_params_tree_matches_reference():
    """The nested hybrid tree: ``stack.mamba.*`` stacked [L], the shared
    layer unstacked; ``from_jax`` checks names at every level."""
    jcfg, tcfg = reduced(ARCHS[ARCH]), treduced(get_config(ARCH))
    jp = jax.tree.map(np.asarray, JBB.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {".".join(str(k.key) for k in path): tuple(a.shape) for path, a
            in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = TBB.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {n: tuple(p.shape) for n, p in tp.named_parameters()} == want
    assert tp["stack"]["shared"]["wq"].shape == (
        tcfg.d_model, tcfg.n_heads, tcfg.resolved_head_dim)
    bad = dict(jp, stack=dict(jp["stack"], shared={
        k: v for k, v in jp["stack"]["shared"].items() if k != "wo"}))
    with pytest.raises(ValueError, match="stack.shared"):
        from_jax(bad, tcfg, "cpu")


def test_group_split_is_index_arithmetic():
    full = get_config(ARCH)
    groups, tail = HY._split_groups(full)
    assert HY.group_shape(full) == (13, 6, 3)
    assert [list(g) for g in groups][-1] == [72, 73, 74, 75, 76, 77]
    assert list(tail) == [78, 79, 80]
    groups, tail = HY._split_groups(treduced(full))
    assert [list(g) for g in groups] == [[0, 1]] and list(tail) == [2]


def test_kv_pool_holds_a_nested_cache():
    """Every leaf of a HybridCache has its slot on axis 1; the pool writes
    and gathers them all in place."""
    def cache(seed):
        g = torch.Generator().manual_seed(seed)
        r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
        return HY.HybridCache(
            ssm_state=r(3, 2, 2, 4, 5), conv=r(3, 2, 3, 6),
            kv=PackedKV(r(1, 2, 2, 4, 8), r(1, 2, 2, 4, 8),
                        torch.arange(16, dtype=torch.int32).reshape(1, 2, 2, 4),
                        torch.ones(1, 2, 2, 4, dtype=torch.bool)))

    pool = KVPool(3, "cpu")
    pool.write([pool.scratch_slot, 1], cache(0))
    ptr = pool.cache.kv.k.data_ptr()
    c1 = cache(1)
    pool.write([2, 0], c1)
    assert pool.cache.kv.k.data_ptr() == ptr
    assert pool.cache.ssm_state.shape == (3, 4, 2, 4, 5)
    got = pool.gather([0, 2])
    assert isinstance(got, HY.HybridCache) and isinstance(got.kv, PackedKV)
    assert torch.equal(got.ssm_state, c1.ssm_state.flip(1))
    assert torch.equal(got.conv, c1.conv.flip(1))
    assert torch.equal(got.kv.pos, c1.kv.pos.flip(1))
