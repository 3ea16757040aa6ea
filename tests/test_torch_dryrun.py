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


# ROADMAP Queue C 1 (no sequence-parallel Reuse), pinned on the production
# mesh: batch 1 is replicated over the 16 data ranks and each rank gathers
# the retained length whole, so the counted FLOPs lie far above the 0.25-4
# band of the cells above and the temp bytes are the whole cache's
# (qwen2-72b's over the card's 80 GB). A repair moves these figures: it
# brings the ratio into the band and updates this test to it.
LONG_FAULT = [("mamba2-130m", 2_378_016), ("qwen2-72b", 86_989_968_200)]


@pytest.mark.parametrize("arch,temp", LONG_FAULT)
def test_long_500k_on_the_production_mesh_pins_queue_c1(arch, temp):
    rec = D.run_cell(arch, "long_500k", mesh_shape=(16, 16), verbose=False)
    assert rec["ok"]
    assert rec["counted_to_analytic"] > 4.0, rec["counted_to_analytic"]
    assert rec["temp_bytes_per_device"] == temp
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
    # gemma-2b's one KV head cannot split over the 16-way model axis for
    # the flash_refresh kernel: the documented divisibility error
    with pytest.raises(ValueError, match="cannot partition over the") as e:
        D.run_cell("gemma-2b", "prefill_32k", flash_refresh=True,
                   verbose=False)
    assert D.is_refusal(e.value)
    assert M.active() is None
    with pytest.raises(ValueError, match="XLA sharding policy"):
        D.run_cell("gemma-2b", "decode_32k", opt_loss=True, verbose=False)


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
