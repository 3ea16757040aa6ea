"""Helpers of the port's tests (``tests/test_torch_*.py``), which import
this module before they build anything.

* **Threads.** Under pytest-xdist every worker is a process of its own,
  and torch's intra-op pool defaults to one thread per core in each: six
  workers on eight cores would run 48 spinning threads, which starve the
  other workers' JAX compiles. The cap gives each worker its share of the
  cores, ``max(1, cores // workers)`` (1 under the tier-1 command's six
  workers on eight cores; every core in a run without xdist). JAX's
  threads are left as they are.
* **Reference serves.** A parity case runs the JAX reference's engine,
  and several cases often compare against the same serve (the port's
  pipelined and synchronous loops, its packed and padded paths, its
  stream events). :func:`cached` keeps each result for the process, keyed
  on what determines it: arch, overrides, serve config, requests, seed.
  Under ``--dist loadfile`` a file's cases share one worker, hence its
  cache.
* **Row keys left out of parity.** :data:`ITER_LOG_DROP` names the
  ``iter_log`` row keys that the parity cases drop from both packages'
  rows: the host's and the device's clocks, and the port's own counters
  that the reference's rows lack.
* **Shard checks.** :func:`shard_check` runs ``python -m
  repro_torch.launch.shard_check`` on two gloo ranks of the CPU and holds
  its record to the tool's law (the mesh files share it).
* **MoE ranks.** :func:`moe_rank` runs one MoE layer on a rank of
  ``launch.mesh.spawn`` (a function of its own module, so a spawned rank
  imports it without the test file's JAX imports).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, Dict, Hashable

import numpy as np
import torch


def thread_cap() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or "1")
    return max(1, (os.cpu_count() or 1) // max(1, workers))


torch.set_num_threads(thread_cap())

_CACHE: Dict[Hashable, object] = {}


def freeze(x) -> Hashable:
    """A hashable stand-in for a key part: arrays by dtype, shape and
    bytes; dicts by sorted items; lists and tuples element by element."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return tuple(sorted((k, freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(freeze(v) for v in x)
    return x


def cached(key, compute: Callable[[], object]):
    """``compute()``, once per ``key`` in this process."""
    k = freeze(key)
    if k not in _CACHE:
        _CACHE[k] = compute()
    return _CACHE[k]


# iter_log row keys of the wall clock (host spans and their Unix-ns
# starts), of the card's timing events, and the port's deferred-step,
# idle-lap and in-place Reuse row counters, which the reference's rows do
# not carry
ITER_LOG_DROP = frozenset({
    "plan_s", "fill_s", "sync_s", "land_s",
    "plan_ns", "fill_ns", "sync_ns", "land_ns",
    "refresh_dev_s", "reuse_dev_s", "logit_dev_s", "iter_dev_s",
    "gap_dev_s", "deferred", "idle_laps", "reuse_in_place"})

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shard_check(arch: str, extra, tmp_path) -> dict:
    """One ``shard_check`` run of ``arch`` on two gloo ranks of the CPU
    (``extra``: its flags); asserts it agreed with the one-device serve on
    a mesh of two, and returns its JSON record."""
    out = tmp_path / "agree.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.shard_check", "--arch",
         arch, "--device", "cpu", "--out", str(out)] + list(extra),
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert rec["ok"], rec
    assert rec["mesh_devices"] == 2, rec
    assert rec["device"] == "cpu" and min(rec["rank_collectives"]) > 0
    if "--sharing" in extra:
        assert rec["shared_hits"] > 0, rec
    return rec


def moe_rank(mesh, cfg, stack: dict, x: np.ndarray, layer: int = 0) -> dict:
    """One rank's MoE layer on ``mesh``: ``stack`` (the ``[nl, ...]`` expert
    stacks as numpy arrays) cut to the rank's shards as the engine cuts
    them (``params.shard_cut``), then ``moe_ffn`` on ``x`` at ``layer``.
    Returns the output, the aux loss, each dispatch the call made (slot,
    keep, token of each slot), the bytes of the rank's stacks and its
    collectives."""
    from repro_torch.launch.sharding import Rules
    from repro_torch.models import moe as TM
    from repro_torch.params import shard_cut
    cut = shard_cut(Rules(cfg, mesh, train=False), mesh)
    held = {k: cut(f"stack/{k}", torch.tensor(v))
            for k, v in stack.items()}
    seen, dispatch = [], TM._dispatch_indices

    def record(*args):
        out = dispatch(*args)
        seen.append([t.numpy().copy() for t in out])
        return out
    TM._dispatch_indices = record
    try:
        out, aux = TM.moe_ffn({k: v[layer] for k, v in held.items()},
                              torch.from_numpy(x), cfg)
    finally:
        TM._dispatch_indices = dispatch
    return dict(out=out.numpy(), aux=float(aux), dispatch=seen,
                shapes={k: tuple(v.shape) for k, v in held.items()},
                bytes=sum(v.numel() * v.element_size()
                          for v in held.values()),
                collectives=mesh.collectives)


# ---------------------------------------------------------------------------
# the mesh's attention placement (test_torch_mesh_attention.py): functions a
# spawned rank imports by name, each given the same numpy inputs on every
# rank and on one device (a ServingMesh((1, 1)): no group, no collective)
# ---------------------------------------------------------------------------

def _kernel_dims(mesh, cfg) -> None:
    """The global kernel dimensions the engine records on its mesh."""
    mesh.kernel_dims = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                            ssm_heads=cfg.ssm_heads if cfg.ssm_state else 0,
                            vocab_size=cfg.vocab_size)


def refresh_rank(mesh, cfg, params, x: np.ndarray, valid: np.ndarray,
                 block_start: np.ndarray, flash: bool) -> dict:
    """A padded and a packed Refresh of one batch over a transformer stack
    (``params``: the reference's tree as numpy, cut to the rank's shards)
    on ``mesh``: each path's hidden state, captured cache and the C3
    scores every ``select_indices`` call saw (the scores after the
    cross-rank merge), and the rank's collectives."""
    from repro_torch.launch.sharding import Rules
    from repro_torch.models import layers as L
    from repro_torch.models import sparse_select as SS
    from repro_torch.models import transformer as T
    from repro_torch.params import from_jax, shard_cut
    _kernel_dims(mesh, cfg)
    cut = shard_cut(Rules(cfg, mesh, train=False), mesh) \
        if mesh.size > 1 else None
    stack = from_jax(params, cfg, "cpu", cut=cut)["stack"]
    B, S, _ = x.shape
    xt, ok = torch.from_numpy(x), torch.from_numpy(valid)
    bs = torch.from_numpy(block_start)
    seen, select = [], SS.select_indices

    def record(scores, *a, **k):
        seen.append(scores.numpy().copy())
        return select(scores, *a, **k)
    SS.select_indices = record
    out = {}
    try:
        serve = T.ServeContext(block_size=8, retain=16, q_chunk=16,
                               use_flash_refresh=flash)
        pos = torch.arange(S, dtype=torch.int32).expand(B, S)
        h, cache, _ = T.forward_full(stack, cfg, xt, pos, token_valid=ok,
                                     serve=serve, block_start=bs)
        out["padded"] = dict(h=h.numpy(), pos=cache.pos.numpy(),
                             valid=cache.valid.numpy(), k=cache.k.numpy(),
                             scores=seen[:])
        # the same requests as one packed stream (their valid prefixes)
        seen.clear()
        lens = ok.sum(dim=1).to(torch.int32)
        cu = torch.cat([torch.zeros(1, dtype=torch.int32),
                        lens.cumsum(0).to(torch.int32)[:-1]])
        flat = torch.cat([xt[b, :int(n)] for b, n in enumerate(lens)])[None]
        seg = torch.repeat_interleave(torch.arange(B, dtype=torch.int32),
                                      lens.long())[None]
        fpos = torch.cat([torch.arange(int(n), dtype=torch.int32)
                          for n in lens])[None]
        pserve = T.ServeContext(block_size=8, retain=16, q_chunk=16,
                                max_seq_len=S)
        h, cache, _ = T.forward_full_packed(
            stack, cfg, flat, fpos, seg, torch.ones_like(seg, dtype=bool),
            cu, lens, bs, pserve)
        out["packed"] = dict(h=h.numpy(), pos=cache.pos.numpy(),
                             valid=cache.valid.numpy(), k=cache.k.numpy(),
                             scores=seen[:])
    finally:
        SS.select_indices = select
    out["collectives"] = mesh.collectives
    out["tp_index"] = L.tp_index()
    return out


def flash_rows_rank(mesh, H: int, K: int, arrays: dict) -> dict:
    """``ops.flash_refresh_attention`` (the plain version of row 7 on the
    CPU) on ``mesh`` with ``H`` query and ``K`` KV heads: its output, and
    the query rows each call of the row-7 entry took."""
    from repro_torch.kernels import flash_refresh as FR
    from repro_torch.kernels import ops
    mesh.kernel_dims = dict(n_heads=H, n_kv_heads=K)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    rows, call = [], FR.flash_refresh_call

    def record(q, k, v, q_pos, *a, **kw):
        rows.append(int(q_pos.shape[1]))
        return call(q, k, v, q_pos, *a, **kw)
    ops.FR.flash_refresh_call = record
    try:
        out = ops.flash_refresh_attention(
            t["q"], t["k"], t["v"], q_pos=t["pos"], kv_pos=t["pos"],
            kv_valid=t["valid"], mask_mode="bidirectional", window=0,
            is_local=False, softcap=0.0)
    finally:
        ops.FR.flash_refresh_call = call
    return dict(out=out.numpy(), rows=rows, collectives=mesh.collectives)


def reuse_rank(mesh, cfg, params, cache, btok: np.ndarray,
               bpos: np.ndarray, kernels: bool) -> dict:
    """``backbone.serve_reuse`` of a batch against ``cache`` (numpy, the
    whole serving cache) on ``mesh``: the weights and the cache cut to the
    rank's shards by ``Rules`` (``Rules.cache``: batch 1 cuts the retained
    length over the data axes, and over ``model`` where the KV heads do
    not divide it), the Reuse merging across the axes that cut it. The
    hidden state, the axes, and the rank's collectives."""
    from repro_torch.core.kv_pool import tree_map_i
    from repro_torch.launch.sharding import (Rules, local_slice,
                                             retained_axes, spec_leaves)
    from repro_torch.models import backbone as BB
    from repro_torch.models import transformer as T
    from repro_torch.params import from_jax, shard_cut
    _kernel_dims(mesh, cfg)
    rules = Rules(cfg, mesh, train=False)
    cut = shard_cut(rules, mesh) if mesh.size > 1 else None
    p = from_jax(params, cfg, "cpu", cut=cut)
    B, Sb = btok.shape
    R = (cache.kv if hasattr(cache, "kv") else cache).k.shape[3]
    spec = rules.cache(B, R)
    specs = spec_leaves(spec)
    local = tree_map_i(lambda i, a: local_slice(torch.from_numpy(a),
                                                specs[i], mesh), cache)
    ctx = T.ServeContext(block_size=Sb, retain=R, use_flash_kernel=kernels,
                         kv_split=retained_axes(spec))
    h = BB.serve_reuse(p, cfg, torch.from_numpy(btok),
                       torch.from_numpy(bpos), local, ctx)
    return dict(h=h.numpy(), kv_split=ctx.kv_split,
                retained=(local.kv if hasattr(local, "kv") else local)
                .k.shape[3], collectives=mesh.collectives)


def engine_gather_rank(mesh, cfg, serve, prompts, seed: int,
                       params) -> dict:
    """One eager serve of ``prompts`` on ``mesh`` (``shard_check``'s
    trace): its ids and counters, and the collectives its pool's
    ``gather`` calls issued."""
    from repro_torch.core.kv_pool import KVPool
    from repro_torch.launch import shard_check as SC
    issued, gather = [], KVPool.gather

    def counted(pool, slots):
        n0 = mesh.collectives
        out = gather(pool, slots)
        issued.append(mesh.collectives - n0)
        return out
    KVPool.gather = counted
    try:
        eng, reqs, stats = SC.serve_trace(cfg, serve, prompts, seed, False,
                                          mesh.device, None, params)
    finally:
        KVPool.gather = gather
    return dict(tokens=[np.asarray(r.output_tokens()) for r in reqs],
                stats={k: getattr(stats, k) for k in SC.COUNTERS},
                gathers=len(issued), gather_collectives=sum(issued),
                collectives=mesh.collectives,
                kv_split=eng.ctx.kv_split)
