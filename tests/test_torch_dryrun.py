"""The meta-device dry run (``repro_torch.launch.dryrun``) against the
reference's placement arithmetic, on the CPU.

The reference's own dry run compiles for 512 placeholder devices in a
subprocess; here its arithmetic is the oracle: ``repro.launch.sharding.
Rules`` specs over its ``SimMesh`` on ``jax.eval_shape`` leaf shapes.

* For six cells covering dense, MoE, ssm, hybrid, vlm and audio and every
  shape kind, the port's parameter shard bytes equal the reference's
  leaf by leaf (exact), its optimizer state and cache bytes equal the
  reference's in total (exact), and ``arg_bytes_per_device`` is the sum
  of its parts. ``counted_flops_per_device`` is positive and within 0.25-4
  of the analytic per-device FLOPs (the record's
  ``counted_to_analytic``).
* ``coll_breakdown`` is empty on a ``(1, 1)`` mesh and not on ``(1, 2)``.
* On the production mesh, ``long_500k`` attends each rank's shard of the
  retained length (ROADMAP Queue C 1), and the ``flash_refresh`` wrapper
  takes the reference's head and query-row branches (Queue C 4).
* The temp tracker is exact on two chained matmuls with a freed
  intermediate; ``flash_refresh``'s meta branch gives the plain version's
  shape and launches nothing.
* The CLI writes ``ok`` records through ``--out`` and never initialises
  CUDA; importing the dry run and the analyzer's CLI sets no environment.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import json
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.mesh import SimMesh as JSimMesh
from repro.launch.sharding import Rules as JRules
from repro.models import backbone as JBB
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_refresh as FR
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import Rules
from repro_torch.params import init_params, named_leaves, shard_cut

ROOT = Path(__file__).resolve().parents[1]
# (arch, shape, mesh): dense / MoE / ssm / hybrid / vlm / audio, each shape
# kind; the long decode on a (1, 16) mesh, whose one sequence is not
# replicated over data ranks
CELLS = [
    ("gemma-2b", "train_4k", (2, 16, 16)),
    ("phi3.5-moe-42b-a6.6b", "train_4k", (16, 16)),
    ("mamba2-130m", "prefill_32k", (16, 16)),
    ("zamba2-7b", "long_500k", (1, 16)),
    ("internvl2-76b", "train_4k", (2, 16, 16)),
    ("musicgen-medium", "decode_32k", (16, 16)),
]
_BYTES = {"bfloat16": 2, "float32": 4, "int32": 4, "bool": 1}


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard_bytes(shape, itemsize, spec, mesh) -> int:
    n = itemsize
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        k = 1
        for a in _axes(entry):
            k *= mesh.shape[a]
        assert dim % k == 0, (shape, spec)
        n *= dim // k
    return n


def _flat(tree, specs):
    P = jax.sharding.PartitionSpec
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    sleaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x:
                                        isinstance(x, P))
    return [(re.sub(r"\['([^']+)'\]", r".\1", jax.tree_util.keystr(kp))[1:],
             leaf, spec) for (kp, leaf), spec in zip(leaves, sleaves)]


def reference_bytes(arch, shape_name, mesh_shape):
    """Per-device bytes the reference's placement gives: parameters leaf
    by leaf, the optimizer state (train) or the cache (decode) in
    total."""
    jcfg = jget_config(arch)
    mesh = JSimMesh(mesh_shape)
    train = shape_name == "train_4k"
    rules = JRules(jcfg, mesh, train=train)
    pshapes = jax.eval_shape(partial(JBB.init_params, jcfg),
                             jax.random.PRNGKey(0))
    params = {name: _shard_bytes(l.shape, l.dtype.itemsize, s, mesh)
              for name, l, s in _flat(pshapes, rules.params(pshapes))}
    out = {"params": params}
    if train:
        oshape = jax.eval_shape(jinit_opt_state, pshapes)
        out["opt_state"] = sum(
            _shard_bytes(l.shape, l.dtype.itemsize, s, mesh)
            for _, l, s in _flat(oshape, rules.opt_state(pshapes)))
    shape = D.SHAPES_BY_NAME[shape_name]
    if shape.kind in ("decode", "long_decode"):
        B, S = shape.global_batch, shape.seq_len
        retain = -(-max(D.BLOCK, int(S * D.RETENTION)) // D.BLOCK) * D.BLOCK
        spec = rules.cache(B, retain)
        db = _BYTES[jcfg.dtype]
        dh = jcfg.resolved_head_dim if jcfg.n_heads else 0

        def kv(nl, sp):
            k = (nl, B, jcfg.n_kv_heads, retain, dh)
            return (2 * _shard_bytes(k, db, sp.k, mesh)
                    + _shard_bytes(k[:-1], 4, sp.pos, mesh)
                    + _shard_bytes(k[:-1], 1, sp.valid, mesh))

        def ssm(sp_state, sp_conv):
            ch = jcfg.d_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state
            st = (jcfg.n_layers, B, jcfg.ssm_heads, jcfg.ssm_head_dim,
                  jcfg.ssm_state)
            cv = (jcfg.n_layers, B, jcfg.ssm_conv_kernel - 1, ch)
            return (_shard_bytes(st, 4, sp_state, mesh)
                    + _shard_bytes(cv, db, sp_conv, mesh))

        if jcfg.family == "ssm":
            out["cache"] = ssm(spec.state, spec.conv)
        elif jcfg.family == "hybrid":
            groups = jcfg.n_layers // jcfg.shared_attn_interval
            out["cache"] = ssm(spec.ssm_state, spec.conv) + kv(groups,
                                                               spec.kv)
        else:
            out["cache"] = kv(jcfg.n_layers, spec)
    return out


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_arg_bytes_equal_reference_placement(arch, shape, mesh):
    mb = 16 if arch in ("qwen2-72b", "internvl2-76b") else 8
    rec = D.run_cell(arch, shape, mesh_shape=mesh, microbatches=mb,
                     verbose=False)
    want = reference_bytes(arch, shape, mesh)
    cfg = get_config(arch)
    rules = Rules(cfg, M.MetaMesh(mesh), train=shape == "train_4k")
    tree = init_params(cfg, None, "meta",
                       cut=shard_cut(rules, M.MetaMesh(mesh)))
    got = {n: t.numel() * t.element_size() for n, t in named_leaves(tree)}
    assert got == want["params"]
    parts = rec["arg_breakdown"]
    assert parts["params"] == sum(want["params"].values())
    for k in ("opt_state", "cache"):
        assert parts.get(k) == want.get(k), k
    assert rec["arg_bytes_per_device"] == sum(parts.values())
    assert rec["ok"] and rec["bottleneck"] in ("compute", "memory",
                                               "collective")
    assert rec["counted_flops_per_device"] > 0
    assert 0.25 <= rec["counted_to_analytic"] <= 4.0, rec["counted_to_analytic"]
    assert rec["temp_bytes_per_device"] > 0
    assert rec["coll_bytes_per_device"] == sum(rec["coll_breakdown"].values())
    assert M.active() is None


# ROADMAP Queue C 1 on the production mesh, repaired: batch 1 cuts the
# retained length over the 16 data ranks (and over the model axis where
# K = 8 does not divide it), and the Reuse merges each rank's shard across
# them. qwen2-72b held 86,989,968,200 temp bytes a device (the whole cache
# gathered) and counted 206.17x the analytic FLOPs before; now at most a
# 16th of those bytes and a tenth of that ratio. What stays above the 0.25-4
# band is batch 1's replication over the data ranks, which the reference's
# placement has too (``Rules.tokens``) and ``roofline.flops`` credits as
# parallel: mamba2-130m has no attention, and its figures are all that.
LONG_FAULT = [("mamba2-130m", 2_378_016), ("qwen2-72b", 86_989_968_200)]


@pytest.mark.parametrize("arch,temp", LONG_FAULT)
def test_long_500k_on_the_production_mesh_pins_queue_c1(arch, temp):
    rec = D.run_cell(arch, "long_500k", mesh_shape=(16, 16), verbose=False)
    assert rec["ok"]
    if arch == "mamba2-130m":
        # no cache to cut: the replicated weight matmuls alone
        assert rec["counted_to_analytic"] > 4.0, rec["counted_to_analytic"]
        assert rec["temp_bytes_per_device"] == temp
    else:
        assert rec["temp_bytes_per_device"] <= temp // 16, \
            rec["temp_bytes_per_device"]
        assert rec["counted_to_analytic"] <= 206.17421160560548 / 10, \
            rec["counted_to_analytic"]
        assert rec["coll_breakdown"]["all-reduce"] > 0
    assert M.active() is None


def _counts():
    return {n: (c.launches, c.plain_calls, c.meta_calls)
            for n, c in build.COUNTERS.items()}


def test_collectives_only_on_a_split_mesh():
    """... and the plain path reaches no kernel wrapper."""
    before = _counts()
    one = D.run_cell("llada-8b", "decode_32k", mesh_shape=(1, 1),
                     verbose=False)
    two = D.run_cell("llada-8b", "decode_32k", mesh_shape=(1, 2),
                     verbose=False)
    assert _counts() == before
    assert one["coll_breakdown"] == {} and one["t_collective"] == 0.0
    assert two["coll_breakdown"].get("all-reduce", 0) > 0
    assert two["arg_breakdown"]["params"] < one["arg_breakdown"]["params"]


def test_refusals_and_the_missing_policy():
    # mamba2-130m's vocabulary (50,280) cannot split over the 16-way model
    # axis for the fused argmax kernel: the documented divisibility error
    # (gemma-2b's flash Refresh, refused here once, now takes the
    # reference's query-row fallback: the tests below)
    with pytest.raises(ValueError, match="cannot partition over the") as e:
        D.run_cell("mamba2-130m", "decode_32k", logit_mode="fused",
                   verbose=False)
    assert D.is_refusal(e.value)
    assert M.active() is None
    with pytest.raises(ValueError, match="XLA sharding policy"):
        D.run_cell("gemma-2b", "decode_32k", opt_loss=True, verbose=False)


def test_straddling_heads_compute_on_a_5_way_model_axis():
    """qwen2.5-14b's 40 query heads on a 5-way model axis put 8 on a rank,
    which straddle its groups of 5 over 8 KV heads: each rank reads one
    KV slot a query head (``transformer.query_kv_range``) and the cell
    runs, where the parent gathered every query head on every rank."""
    rec = D.run_cell("qwen2.5-14b", "decode_32k", mesh_shape=(1, 5),
                     verbose=False)
    assert rec["ok"] and 0.25 <= rec["counted_to_analytic"] <= 4.0, rec
    assert M.active() is None


def _refresh_on_meta(H, K, dh, S=64):
    """``ops.flash_refresh_attention`` on rank 0 of ``MetaMesh((16, 16))``
    with H query and K KV heads, H not dividing the model axis (q and k/v
    whole on every rank): the output, the row-7 q shapes and the
    collective log."""
    from repro_torch.kernels import ops
    mesh = M.MetaMesh((16, 16))
    mesh.kernel_dims = dict(n_heads=H, n_kv_heads=K)
    q = torch.empty((1, S, H, dh), device="meta")
    kv = torch.empty((1, S, K, dh), device="meta")
    pos = torch.empty((1, S), dtype=torch.int32, device="meta")
    ok = torch.empty((1, S), dtype=torch.bool, device="meta")
    seen, call = [], FR.flash_refresh_call

    def record(q, *a, **kw):
        seen.append(tuple(q.shape))
        return call(q, *a, **kw)
    calls = FR.REFRESH.meta_calls
    ops.FR.flash_refresh_call = record
    try:
        with M.using(mesh):
            out = ops.flash_refresh_attention(
                q, kv, kv, q_pos=pos, kv_pos=pos, kv_valid=ok,
                mask_mode="bidirectional", window=0, is_local=False,
                softcap=0.0)
    finally:
        ops.FR.flash_refresh_call = call
    assert FR.REFRESH.meta_calls == calls + 1
    return out, seen, mesh.log


def test_flash_refresh_head_split_on_the_production_mesh():
    """qwen2-72b's heads (64 over 8 KV heads, G = 8) on a 16-way model
    axis, through the model's call (one layer's padded Refresh with
    ``use_flash_refresh``, batch 16 and S 256 on rank 0 of
    ``MetaMesh((16, 16))``): rank 0's 4 query heads against the one KV
    head they read (the reference's head branch; the model layer slices
    the KV head, the wrapper takes what it is given)."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig
    cfg = dataclasses.replace(get_config("qwen2-72b"), n_layers=1)
    mesh = M.MetaMesh((16, 16))
    mesh.kernel_dims = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                            ssm_heads=0, vocab_size=cfg.vocab_size)
    seen, call = [], FR.flash_refresh_call

    def record(q, *a, **kw):
        seen.append(tuple(q.shape))
        return call(q, *a, **kw)
    FR.flash_refresh_call = record
    try:
        with M.using(mesh):
            step, _ = D.prefill_step(
                cfg, ShapeConfig("t", "prefill", 256, 16), mesh, "head",
                D.RETENTION, "chunked", True, D._Counts(), D.MetaMemory())
            step()
    finally:
        FR.flash_refresh_call = call
    assert seen == [(1, 1, 256 * 4, 128)]
    assert M.active() is None


def test_flash_refresh_query_rows_on_the_production_mesh():
    """gemma-2b's heads (8 over 1) do not divide 16: rank 0 attends 4 of
    the 64 query rows against the whole K/V, and the rows are gathered
    over the model axis (the reference's sequence branch)."""
    out, seen, log = _refresh_on_meta(8, 1, 256)
    assert tuple(out.shape) == (1, 64, 8, 256)
    assert seen == [(1, 1, 4 * 8, 256)]
    assert log == {"all-gather": 64 * 8 * 256 * 4}


def test_meta_memory_on_chained_matmuls():
    n = 64
    a = torch.empty(n, n, device="meta")
    b = torch.empty(n, n, device="meta")
    mem = D.MetaMemory()
    mem.hold([a, b])
    with mem:
        c = a @ b
        d = c @ b
        del c
        e = d.view(-1)          # a view: no new storage
        d.add_(1)               # in place: no new storage
        f = a[0]                # a view of an argument: not counted
    one = n * n * 4
    assert mem.peak == 2 * one and mem.live == one
    del d, e, f
    assert mem.live == 0


def test_flash_refresh_meta_branch_has_the_plain_shape():
    B, K, G, S, dh = 2, 2, 3, 16, 64
    args = [torch.randn(B, K, S * G, dh), torch.randn(B, K, S, dh),
            torch.randn(B, K, S, dh),
            torch.arange(S, dtype=torch.int32).expand(B, S),
            torch.arange(S, dtype=torch.int32).expand(B, S),
            torch.ones(B, S, dtype=torch.bool)]
    plain = FR.refresh_attention_plain(*args, False)
    before = (FR.REFRESH.launches, FR.REFRESH.plain_calls,
              FR.REFRESH.meta_calls)
    out = FR.flash_refresh_call(*[t.to("meta") for t in args], False)
    assert out.device.type == "meta"
    assert out.shape == plain.shape and out.dtype == plain.dtype
    assert (FR.REFRESH.launches, FR.REFRESH.plain_calls,
            FR.REFRESH.meta_calls) == (before[0], before[1], before[2] + 1)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "positions"])
def test_flash_refresh_meta_branch_refuses_what_the_kernel_refuses(bad):
    """Meta tensors meet the kernel path's shape and dtype checks before
    the shape pass: a dry run's ``ok`` means the kernel takes the call."""
    B, K, G, S = 2, 2, 3, 16
    dh = 48 if bad == "head_dim" else 64
    pos = torch.int64 if bad == "positions" else torch.int32
    q = torch.empty(B, K, S * G, dh, device="meta")
    k = torch.empty(B, K, S, dh, device="meta",
                    dtype=torch.bfloat16 if bad == "dtype" else None)
    v = torch.empty(B, K, S, dh, device="meta")
    p = torch.empty(B, S, dtype=pos, device="meta")
    ok = torch.empty(B, S, dtype=torch.bool, device="meta")
    calls = FR.REFRESH.meta_calls
    with pytest.raises((ValueError, TypeError)):
        FR.flash_refresh_call(q, k, v, p, p, ok, False)
    assert FR.REFRESH.meta_calls == calls


def test_cli_writes_ok_records_without_cuda(tmp_path):
    out = tmp_path / "dry.json"
    code = (
        "import os, runpy, sys, torch\n"
        "env0 = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis.__main__\n"
        "assert dict(os.environ) == env0, 'an import set the environment'\n"
        f"sys.argv = ['dryrun', '--arch', 'mamba2-130m', '--shape', "
        f"'decode_32k', '--both-meshes', '--out', {str(out)!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('RESULT', rc, torch.cuda.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "RESULT 0 False" in res.stdout, res.stdout
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for r in recs:
        assert r["ok"] and r["bottleneck"] in ("compute", "memory",
                                               "collective")
