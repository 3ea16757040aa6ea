"""The mesh's attention on the reference's placement, on gloo ranks of the
CPU (``launch.mesh.spawn``), each case against one device:

* **a head-split Refresh** (``n_heads=4, n_kv_heads=1`` on ``(1, 2)``):
  each rank attends its two query heads against the one KV head they
  read, and one max over the model axis gives the C3 scores. The padded
  and the packed Refresh, with and without the ``flash_refresh`` wrapper:
  the first layer's scores bit for bit (a later layer's inputs carry the
  model axis's reordered sums: within 1e-5), the selected positions
  exactly, the hidden state and the captured keys within 1e-5 of the
  largest magnitude. Also ``n_heads=12, n_kv_heads=3``, whose six query
  heads a rank straddle the groups of four (one KV slot a query head);
* **the flash Refresh's query-sequence fallback** (``n_heads=3,
  n_kv_heads=1`` on ``(1, 2)``: the heads do not divide the model axis):
  each rank's row-7 call takes half the query rows, and the gathered
  output equals one device's and, within 1e-5, the reference's
  ``repro.kernels.ops.flash_refresh_attention`` under a 2-device host
  mesh (a subprocess);
* **a Reuse on a cut retained length**: batch 1 cut over ``data`` at
  ``(2, 1)`` (dense with row 6's plain version, and the hybrid's shared
  block), and over ``model`` at ``(1, 2)`` where the one KV head does not
  divide it; within 1e-5 of the largest magnitude;
* **an engine serve** of a hybrid whose shared block has one KV head, at
  ``(1, 2)``: ids and every counter exact, and the pool's ``gather``
  issues no collective (the stage takes the rank's cut);
* the Reuse passes over ``[cache ; block]`` at once (the concatenated
  pass, the flat varlen kernel) refuse a cut retained length.

Each one-device run is also held to the reference's on the same inputs
and weights (``REF_TOL``, or exactly: ids, counters, selected positions).

The configs were checked for float32 near-ties at the retention boundary
and in the served ids before their seeds were pinned (ROADMAP Queue C 6).
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core.engine import Engine as JEngine
from repro.models import backbone as JBB
from repro.models import hybrid as JHY
from repro.models import sparse_select as JSS
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.launch import mesh as M
from repro_torch.launch import shard_check as SC
from repro_torch.models import transformer as T
from repro_torch.models.hybrid import HybridCache
from repro_torch.models.sparse_select import PackedKV
from repro_torch.params import from_jax
from torch_testing import (REPO, engine_gather_rank, flash_rows_rank,
                           refresh_rank, reuse_rank)

TOL = 1e-5          # of the largest magnitude: float32, reordered sums
REF_TOL = 1e-4      # port against reference, float32 (test_torch_padded)
ONE = M.ServingMesh((1, 1), "cpu")


def _configs(arch, **over):
    """(the reference's, the port's) reduced config of ``arch``."""
    return (dataclasses.replace(reduced(ARCHS[arch]), **over),
            dataclasses.replace(treduced(get_config(arch)), **over))


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JBB.init_params(
        jcfg, jax.random.PRNGKey(seed)))


def _close(got, want, tol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _reference_refresh(jcfg, params, x, valid, bs, flash):
    """The reference's padded and packed Refresh of ``refresh_rank``'s
    batch: each path's hidden state and captured cache."""
    jp = jax.tree.map(jnp.asarray, params)["stack"]
    B, S, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    h, cache, _ = JT.forward_full(
        jp, jcfg, jnp.asarray(x), pos, token_valid=jnp.asarray(valid),
        serve=JT.ServeContext(block_size=8, retain=16, q_chunk=16,
                              use_flash_refresh=flash),
        block_start=jnp.asarray(bs))
    out = {"padded": (h, cache)}
    lens = valid.sum(axis=1).astype(np.int32)
    cu = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    flat = np.concatenate([x[b, :n] for b, n in enumerate(lens)])[None]
    seg = np.repeat(np.arange(B, dtype=np.int32), lens)[None]
    fpos = np.concatenate([np.arange(n, dtype=np.int32)
                           for n in lens])[None]
    h, cache, _ = JT.forward_full_packed(
        jp, jcfg, jnp.asarray(flat), jnp.asarray(fpos), jnp.asarray(seg),
        jnp.ones(seg.shape, bool), jnp.asarray(cu), jnp.asarray(lens),
        jnp.asarray(bs), JT.ServeContext(block_size=8, retain=16,
                                         q_chunk=16, max_seq_len=S))
    out["packed"] = (h, cache)
    return out


# (heads, KV heads, flash_refresh): one KV head under two query heads a
# rank, and twelve over three KV heads, six a rank straddling the groups
HEAD_SPLIT = [(4, 1, False), (4, 1, True), (12, 3, True)]


@pytest.mark.parametrize("H,K,flash", HEAD_SPLIT,
                         ids=["plain", "flash", "straddle-flash"])
def test_head_split_refresh_equals_one_device(H, K, flash):
    jcfg, cfg = _configs("llada-8b", n_heads=H, n_kv_heads=K, n_layers=2)
    params = _params(jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    valid = np.arange(32)[None] < np.array([[32], [27]])
    bs = np.array([8, 16], np.int32)
    one = refresh_rank(ONE, cfg, params, x, valid, bs, flash)
    ref = _reference_refresh(jcfg, params, x, valid, bs, flash)
    for path in ("padded", "packed"):
        h, cache = ref[path]
        assert np.array_equal(one[path]["pos"], np.asarray(cache.pos)), path
        assert np.array_equal(one[path]["valid"], np.asarray(cache.valid))
        _close(one[path]["h"], np.asarray(h), REF_TOL)
        _close(one[path]["k"], np.asarray(cache.k), REF_TOL)
    ranks = M.spawn(refresh_rank, (1, 2), "cpu", cfg, params, x, valid, bs,
                    flash)
    assert [r["tp_index"] for r in ranks] == [0, 1]
    for got in ranks:
        assert got["collectives"] > 0
        for path in ("padded", "packed"):
            a, b = one[path], got[path]
            assert len(a["scores"]) == len(b["scores"]) == cfg.n_layers
            # the first layer's inputs are the same bits on both sides, and
            # so are its scores; a later layer's inputs carry the model
            # axis's reordered sums
            assert np.array_equal(a["scores"][0], b["scores"][0]), path
            for sa, sb in zip(a["scores"][1:], b["scores"][1:]):
                fin = np.isfinite(sa)
                assert np.array_equal(fin, np.isfinite(sb)), path
                _close(sb[fin], sa[fin])
            assert np.array_equal(a["pos"], b["pos"]), path
            assert np.array_equal(a["valid"], b["valid"]), path
            _close(b["h"], a["h"])
            _close(b["k"], a["k"])


_REF_ROWS = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.kernels import ops as JO
from repro.jax_compat import use_mesh
z = np.load(sys.argv[1])
with use_mesh(jax.make_mesh((1, 2), ("data", "model"))):
    out = JO.flash_refresh_attention(
        jnp.asarray(z["q"]), jnp.asarray(z["k"]), jnp.asarray(z["v"]),
        q_pos=jnp.asarray(z["pos"]), kv_pos=jnp.asarray(z["pos"]),
        kv_valid=jnp.asarray(z["valid"]), mask_mode="bidirectional",
        window=0, is_local=False, softcap=0.0)
np.save(sys.argv[2], np.asarray(out))
"""


def test_flash_refresh_query_rows_fallback(tmp_path):
    H, K, B, S, dh = 3, 1, 2, 16, 16
    rng = np.random.default_rng(1)
    arrays = dict(
        q=rng.standard_normal((B, S, H, dh)).astype(np.float32),
        k=rng.standard_normal((B, S, K, dh)).astype(np.float32),
        v=rng.standard_normal((B, S, K, dh)).astype(np.float32),
        pos=np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy(),
        valid=np.arange(S)[None] < np.array([[S], [13]]))
    one = flash_rows_rank(ONE, H, K, arrays)
    assert one["rows"] == [S] and one["collectives"] == 0
    ranks = M.spawn(flash_rows_rank, (1, 2), "cpu", H, K, arrays)
    for got in ranks:
        assert got["rows"] == [S // 2] and got["collectives"] == 1
        assert np.array_equal(got["out"], one["out"])
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", _REF_ROWS,
                        str(tmp_path / "in.npz"), str(tmp_path / "ref.npy")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    _close(ranks[0]["out"], np.load(tmp_path / "ref.npy"))


def _cache(cfg, R, seed):
    """A batch-1 serving cache of ``cfg``'s family, ``R`` retained rows a
    KV head: random keys and values at distinct sorted positions below
    ``R + 16``, a fifth of them invalid, and one head with no valid key
    in its second half (a shard whose rows all mask)."""
    rng = np.random.default_rng(seed)
    K, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    nl = (cfg.n_layers // cfg.shared_attn_interval
          if cfg.family == "hybrid" else cfg.n_layers)
    shape = (nl, 1, K, R)
    pos = np.sort(np.stack([rng.choice(R + 16, R, replace=False)
                            for _ in range(int(np.prod(shape[:-1])))]),
                  axis=-1).reshape(shape).astype(np.int32)
    valid = rng.random(shape) < 0.8
    valid[:, :, 0, R // 2:] = False
    kv = PackedKV(*(rng.standard_normal(shape + (dh,)).astype(np.float32)
                    for _ in range(2)), pos, valid)
    if cfg.family != "hybrid":
        return kv
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return HybridCache(
        ssm_state=rng.standard_normal(
            (cfg.n_layers, 1, cfg.ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state)).astype(np.float32),
        conv=rng.standard_normal(
            (cfg.n_layers, 1, cfg.ssm_conv_kernel - 1, ch)).astype(
                np.float32),
        kv=kv)


# (arch, overrides, mesh, row 6 on, the axes that cut the retained length)
REUSE = [
    ("llada-8b", {}, (2, 1), True, ("data",)),
    ("zamba2-7b", {}, (2, 1), False, ("data",)),
    ("qwen2-72b", dict(n_kv_heads=1), (1, 2), False, ("model",)),
]


@pytest.mark.parametrize("arch,over,mesh,kernels,axes", REUSE,
                         ids=["dense-2x1", "hybrid-2x1", "mqa-1x2"])
def test_batch1_reuse_on_a_cut_retained_length(arch, over, mesh, kernels,
                                               axes):
    jcfg, cfg = _configs(arch, **over)
    params = _params(jcfg, seed=2)
    R, Sb = 32, 8
    cache = _cache(cfg, R, seed=3)
    rng = np.random.default_rng(4)
    btok = rng.integers(0, cfg.vocab_size - 1, (1, Sb)).astype(np.int32)
    bpos = (R + 8 + np.arange(Sb, dtype=np.int32))[None]
    one = reuse_rank(ONE, cfg, params, cache, btok, bpos, kernels)
    assert one["kv_split"] == () and one["retained"] == R
    jkv = JSS.PackedKV(*map(jnp.asarray,
                            getattr(cache, "kv", cache)))
    jcache = (JHY.HybridCache(jnp.asarray(cache.ssm_state),
                              jnp.asarray(cache.conv), jkv)
              if cfg.family == "hybrid" else jkv)
    want = JBB.serve_reuse(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(btok),
        jnp.asarray(bpos), jcache,
        JT.ServeContext(block_size=Sb, retain=R, use_flash_kernel=kernels))
    _close(one["h"], np.asarray(want), REF_TOL)
    for got in M.spawn(reuse_rank, mesh, "cpu", cfg, params, cache, btok,
                       bpos, kernels):
        assert got["kv_split"] == axes and got["retained"] == R // 2
        assert got["collectives"] > 0
        _close(got["h"], one["h"])


def test_engine_serve_on_a_model_cut_retained_length():
    jcfg, cfg = _configs("zamba2-7b", n_kv_heads=1)
    params = _params(jcfg, seed=0)
    serve = SC.serve_config()
    prompts = SC.trace_prompts(cfg, 5, 0)
    _, reqs, stats = SC.serve_trace(cfg, serve, prompts, 0, False, "cpu",
                                    None, params)
    want = [np.asarray(r.output_tokens()) for r in reqs]
    je = JEngine(jcfg, JServe(**{f: getattr(serve, f) for f in (
        "max_num_batched_tokens", "max_num_logits", "block_size",
        "steps_per_block", "max_seq_len", "max_slots",
        "max_refresh_per_iter", "logit_mode", "varlen_pack",
        "token_bucket")}), params=jax.tree.map(jnp.asarray, params))
    jreqs = [je.submit(p, gen_len=16, arrival=0.0, rid=i)
             for i, p in enumerate(prompts)]
    js = je.run()
    for r, ids in zip(jreqs, want):
        assert np.array_equal(np.asarray(r.output_tokens()), ids), r.rid
    for name in SC.COUNTERS:
        assert getattr(stats, name) == getattr(js, name), name
    ranks = M.spawn(engine_gather_rank, (1, 2), "cpu", cfg,
                    dataclasses.replace(serve, mesh_shape=(1, 2)), prompts,
                    0, params)
    for got in ranks:
        assert got["kv_split"] == ("model",)
        assert got["gathers"] > 0 and got["gather_collectives"] == 0
        assert got["collectives"] > 0
        for a, b in zip(want, got["tokens"]):
            assert np.array_equal(a, b)
        for name in SC.COUNTERS:
            assert got["stats"][name] == getattr(stats, name), name


@pytest.mark.parametrize("flat", [False, True], ids=["concat", "flat"])
def test_whole_pass_reuse_refuses_a_cut_retained_length(flat):
    """The concatenated pass and the flat varlen kernel attend the whole
    retained length at once and merge nothing across ranks: given a cut
    one (``kv_split``) they raise the documented wording, on the CPU
    before any kernel or collective."""
    cfg = treduced(get_config("llada-8b"))
    stack = from_jax(_params(_configs("llada-8b")[0]), cfg,
                     "cpu")["stack"]
    rng = np.random.default_rng(5)
    R, Sb, Cr = 2, 8, 16
    K, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, R, K, Cr)
    cache = PackedKV(
        *(torch.from_numpy(rng.standard_normal(shape + (dh,)).astype(
            np.float32)) for _ in range(2)),
        torch.arange(Cr, dtype=torch.int32).expand(shape).contiguous(),
        torch.ones(shape, dtype=torch.bool))
    xb = torch.from_numpy(rng.standard_normal((R, Sb, cfg.d_model)).astype(
        np.float32))
    bpos = (Cr + torch.arange(Sb, dtype=torch.int32)).expand(R, Sb)
    ctx = T.ServeContext(block_size=Sb, retain=Cr, use_flash_kernel=flat,
                         reuse_concat=not flat, kv_split=("data",))
    with pytest.raises(ValueError, match="cannot partition over the data"):
        if flat:
            T.forward_block_packed(stack, cfg, xb, bpos, cache, serve=ctx)
        else:
            T.forward_block(stack, cfg, xb, bpos, cache, serve=ctx)
    # the same call on the whole retained length runs
    whole = dataclasses.replace(ctx, kv_split=())
    run = T.forward_block_packed if flat else T.forward_block
    assert torch.isfinite(run(stack, cfg, xb, bpos, cache,
                              serve=whole)).all()
