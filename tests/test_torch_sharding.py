"""Mesh serving's arithmetic, held exactly to the reference's: the
``Rules`` parameter and cache specs, ``kernel_partition_plan``, every
per-device byte count of the memory plan, and the modeled clock's work
split. In process, over ``SimMesh``es (no device, no process group).

Specs are compared normalised on both sides (None -> (), a name ->
(name,), one entry per dimension): jax 0.9 turns a one-name tuple in a
``PartitionSpec`` into the bare name, which names the same sharding.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import ServeConfig as JServe
from repro.core import budgeting as JB
from repro.launch.mesh import SimMesh as JSimMesh
from repro.launch.sharding import Rules as JRules
from repro.launch.sharding import kernel_partition_plan as jplan
from repro.models import backbone as JBB
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import budgeting as TB
from repro_torch.core.engine import Engine as TEngine
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import (Rules, kernel_partition_plan,
                                         local_slice, spec_leaves)
from repro_torch.launch.shard_check import pool_close
from repro_torch.params import (from_jax, init_params, named_leaves,
                                shapes, shard_cut, shard_params)

ARCHS = sorted(JARCHS)
MESHES = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 16), (16, 16))


def _norm(spec, ndim):
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out + [()] * (ndim - len(out)))


def _jleaves(tree):
    """A reference cache spec tree's specs in field order."""
    if hasattr(tree, "_fields"):
        return [s for f in tree for s in _jleaves(f)]
    return [tree]


@functools.lru_cache(maxsize=None)
def _jshapes(arch):
    return jax.eval_shape(functools.partial(JBB.init_params, JARCHS[arch]),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_specs_equal_the_reference(arch):
    """Every parameter leaf's spec (train on and off) and every cache
    spec (streams, the data-sharded pool, batch- and sequence-parallel
    layouts) equal the reference's on each mesh."""
    jcfg, tcfg = JARCHS[arch], TARCHS[arch]
    jtree = _jshapes(arch)
    jleaves, jdef = jax.tree.flatten(jtree)
    tshapes = shapes(tcfg)
    for mesh, train in itertools.product(MESHES, (False, True)):
        jr = JRules(jcfg, JSimMesh(mesh), train=train)
        tr = Rules(tcfg, M.SimMesh(mesh), train=train)
        jspecs = jdef.flatten_up_to(jr.params(jtree))
        tspecs = spec_leaves(tr.params(tshapes))
        assert len(jspecs) == len(tspecs)
        for leaf, js, ts in zip(jleaves, jspecs, tspecs):
            assert _norm(js, leaf.ndim) == _norm(ts, leaf.ndim), \
                (mesh, train, leaf.shape, js, ts)
        for batch, retain, dp, sdp in itertools.product(
                (1, 9, 16), (64, 120, 63), (True, False), (False, True)):
            js = _jleaves(jr.cache(batch, retain, data_parallel=dp,
                                   slot_data_parallel=sdp))
            ts = spec_leaves(tr.cache(batch, retain, data_parallel=dp,
                                      slot_data_parallel=sdp))
            assert [_norm(s, 5) for s in js] == [_norm(s, 5) for s in ts], \
                (mesh, batch, retain, dp, sdp)


def test_kernel_partition_plan_equals_the_reference():
    """The grid of the reference's property test, exhaustively: the same
    plan, or the same ValueError."""
    jmeshes = ((1, 1), (1, 2), (2, 2), (1, 3), (2, 4), (1, 16), (2, 2, 2))
    n = 0
    for arch, mesh, n_heads, kv_div, flash, fused in itertools.product(
            ("llada-8b", "mamba2-130m", "zamba2-7b"), jmeshes,
            (1, 2, 3, 4, 6, 8), (1, 2, 4), (False, True), (False, True)):
        kv = max(1, n_heads // kv_div)
        if n_heads % kv:
            kv = n_heads
        kw = dict(mesh_shape=mesh, use_flash_kernel=flash,
                  logit_mode="fused" if fused else "chunked")
        jcfg = jreduced(JARCHS[arch], n_heads=n_heads, n_kv_heads=kv)
        tcfg = treduced(TARCHS[arch], n_heads=n_heads, n_kv_heads=kv)
        try:
            want = jplan(jcfg, JServe(**kw))
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                kernel_partition_plan(tcfg, TServe(**kw))
            assert str(got.value) == str(e)
            n += 1
            continue
        assert kernel_partition_plan(tcfg, TServe(**kw)) == want
    assert n > 0


SERVES = (dict(), dict(logit_mode="monolithic", varlen_pack=False),
          dict(logit_mode="fused", vocab_tile=512), dict(kv_quant="int8"),
          dict(prefix_sharing=True, max_slots=64))


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_bytes_equal_the_reference(arch):
    """weight_bytes_per_device, kv_slot_bytes, logit_activation_bytes,
    backbone_activation_bytes and plan_memory (every field) on each mesh,
    exactly."""
    jcfg, tcfg = JARCHS[arch], TARCHS[arch]
    for mesh in (None,) + MESHES:
        assert TB.weight_bytes_per_device(tcfg, mesh) == \
            JB.weight_bytes_per_device(jcfg, mesh), mesh
        for kw in SERVES:
            js, ts = JServe(mesh_shape=mesh, **kw), TServe(mesh_shape=mesh,
                                                           **kw)
            assert TB.kv_slot_bytes(tcfg, ts) == JB.kv_slot_bytes(jcfg, js)
            for n in (1, 100, 4000):
                assert TB.logit_activation_bytes(tcfg, ts, n) == \
                    JB.logit_activation_bytes(jcfg, js, n)
            assert TB.backbone_activation_bytes(tcfg, ts) == \
                JB.backbone_activation_bytes(jcfg, js)
            for hbm in (24 << 30, 80 << 30):
                want = JB.plan_memory(jcfg, js, hbm, share_factor=1.5)
                got = TB.plan_memory(tcfg, ts, hbm, share_factor=1.5)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (mesh, kw)


@pytest.mark.parametrize("arch", ["llada-8b", "gemma-2b", "mamba2-130m",
                                  "zamba2-7b", "qwen2.5-14b"])
def test_engine_work_split_is_the_reference_formula(arch):
    """The modeled clock's credit: the model axis's sharded share of the
    weights times the data axis's replicas (the reference engine's
    ``_tp_work_split · _dp_work_split``). Built on rank 0 of each mesh,
    whose construction issues no collective."""
    jcfg, tcfg = jreduced(JARCHS[arch]), treduced(TARCHS[arch])
    for mesh in ((1, 2), (2, 1), (2, 2), (1, 4)):
        d, m = mesh
        want = 1.0
        if m > 1:
            want = (JB.weight_bytes_per_device(jcfg, None)
                    / JB.weight_bytes_per_device(jcfg, (1, m)))
        if d > 1:
            want *= float(d)
        M.activate(M.ServingMesh(mesh, "cpu", backend="gloo"))
        try:
            eng = TEngine(tcfg, TServe(mesh_shape=mesh), device="cpu")
        finally:
            M.activate(None)
        assert eng.work_split == want, mesh
        assert eng.mesh_devices == d * m


def test_local_slice_cuts_each_rank_its_block():
    """Rank (d, m) of a (2, 2) mesh: a dim over ``model`` gives block m, a
    dim over ``(data, model)`` block 2d + m, a dim over nothing stays
    whole (the same tensor)."""
    t = torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    for d, m in itertools.product(range(2), range(2)):
        mesh = M.ServingMesh((2, 2), "cpu", rank=2 * d + m)
        got = local_slice(t, ("model", ("data", "model"), None), mesh)
        k = 2 * d + m
        assert torch.equal(got, t[2 * m: 2 * m + 2, 2 * k: 2 * k + 2])
    assert local_slice(t, (None, None, None), mesh) is t


@pytest.mark.parametrize("arch", ["llada-8b", "zamba2-7b"])
def test_leaves_are_cut_as_they_are_drawn(arch):
    """``init_params`` and ``from_jax`` with a ``shard_cut`` give each
    leaf of rank (0, 1) of a (1, 2) mesh exactly the shard that
    ``shard_params`` cuts from the whole tree, in a storage of its own
    (the whole leaf is freed before the next is drawn)."""
    cfg = treduced(TARCHS[arch])
    mesh = M.ServingMesh((1, 2), "cpu", rank=1)
    rules = Rules(cfg, mesh, train=False)
    cut = shard_cut(rules, mesh)
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = named_leaves(shard_params(whole, rules, mesh))

    def to_numpy(g):
        out = {n: to_numpy(c) for n, c in g.named_children()}
        out.update({n: t.numpy() for n, t in g.items()})
        return out
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        cut=cut)
    landed = from_jax(to_numpy(whole), cfg, "cpu", cut=cut)
    split = 0
    for got in (named_leaves(drawn), named_leaves(landed)):
        assert [n for n, _ in got] == [n for n, _ in want]
        for (n, a), (_, b) in zip(want, got):
            assert torch.equal(a, b), n
            assert b.untyped_storage().nbytes() == b.nbytes, n
            split += a.shape != dict(named_leaves(whole))[n].shape
    assert split > 0


def test_pool_law_is_the_references_within_unit_scale():
    """``shard_check.pool_close``: a leaf within [-1, 1] is held to
    ``allclose(atol=1e-5, rtol=1e-5)`` exactly; a larger leaf's atol is
    1e-5 of its largest magnitude."""
    ref = np.array([0.5, -1.0, 0.0], np.float32)
    assert pool_close(ref, ref + np.float32(0.9e-5))
    assert not pool_close(ref, ref + np.float32(1.1e-5))
    big = np.array([7.0, 0.0], np.float32)
    assert pool_close(big, big + np.float32([0.0, 6.9e-5]))
    assert not pool_close(big, big + np.float32([0.0, 7.1e-5]))


def test_vocab_merge_breaks_ties_low_and_sums_exactly():
    """The cross-shard argmax reduce: the lowest global index among the
    shards that reach the max (a tie across shards resolves to the lower
    shard, as one device's argmax does), and the rescaled sum."""
    ids = torch.tensor([[3, 1, 0], [2, 0, 5]], dtype=torch.int32)
    mx = torch.tensor([[1.0, 2.0, 0.5], [1.0, 3.0, 0.5]])
    s = torch.tensor([[2.0, 1.0, 1.0], [3.0, 1.0, 4.0]])
    gid, m_max, tot = ops.merge_vocab_shards(ids, mx, s, 10)
    assert gid.tolist() == [3, 10, 0]
    assert m_max.tolist() == [1.0, 3.0, 0.5]
    want = s[0] * torch.exp(mx[0] - m_max) + s[1] * torch.exp(mx[1] - m_max)
    assert torch.equal(tot, want)
    # and it is the one-device result on a split vocabulary
    z = torch.randn(7, 12, generator=torch.Generator().manual_seed(0))
    z[:, 9] = z[:, 2] = z.amax(dim=1) + 1.0           # a tie across shards
    parts = z.split(6, dim=1)
    gid, m_max, tot = ops.merge_vocab_shards(
        torch.stack([p.argmax(dim=1).int() for p in parts]),
        torch.stack([p.amax(dim=1) for p in parts]),
        torch.stack([torch.exp(p - p.amax(dim=1, keepdim=True)).sum(dim=1)
                     for p in parts]), 6)
    assert torch.equal(gid.long(), z.argmax(dim=1))
    assert gid.tolist() == [2] * 7
    torch.testing.assert_close(
        tot, torch.exp(z - z.amax(dim=1, keepdim=True)).sum(dim=1),
        rtol=1e-6, atol=0)


def test_one_device_mesh_is_the_identity():
    """A (1, 1) mesh holds no group: every collective returns its input."""
    mesh = M.ServingMesh((1, 1), "cpu")
    x = torch.randn(3, 4)
    assert mesh.all_reduce(x, "model") is x
    assert mesh.all_gather(x, "data", dim=1) is x
    assert mesh.broadcast(x) is x
    assert mesh.broadcast_float(2.5) == 2.5 and mesh.collectives == 0
