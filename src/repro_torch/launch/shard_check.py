"""One-device against mesh serving agreement: the sharding oracle of
``repro.launch.shard_check``, on the port.

The same trace (all arrivals at 0, so planning depends only on budget and
slot state, never on the clock) is served twice:

1. the one-device engine (no mesh), in this process;
2. the same engine on a ``(data, model)`` or ``(pod, data, model)`` mesh,
   one rank a device
   (``launch.mesh.spawn``): weights cut by ``Rules.params``, the slot pool
   by ``Rules.cache``, the logit stage vocab-parallel, an MoE layer on
   the reference's expert placement.

They must agree on the committed token ids (exact), the ``EngineStats``
token counters of :data:`COUNTERS` (exact), the slot pool over the real
and scratch slots (:func:`pool_close`: the model axis's sums reorder float
additions) and ``mesh_devices`` (the mesh's size: it never collapses);
and each rank must hold the parameter bytes the memory plan bills a
device (``budgeting.weight_bytes_per_device``).

On the CPU (gloo ranks):
  PYTHONPATH=src python -m repro_torch.launch.shard_check --arch llada-8b \\
      --device cpu --mesh 1,2 [--kernels] [--padded] [--sharing --n 6]
  PYTHONPATH=src python -m repro_torch.launch.shard_check \
      --arch phi3.5-moe-42b-a6.6b --device cpu --mesh 2,1,1
On one card, the ranks co-located over gloo (eager, no graphs):
  PYTHONPATH=src python -m repro_torch.launch.shard_check --arch llada-8b \\
      --device cuda --colocate --kernels

Prints the result JSON and exits non-zero on any difference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.baselines import system_profiles
from repro_torch.core.budgeting import weight_bytes_per_device
from repro_torch.core.engine import Engine
from repro_torch.core.kv_pool import tree_leaves
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import Rules
from repro_torch.params import from_jax, shard_cut

COUNTERS = ("committed_tokens", "iterations", "refresh_steps", "reuse_steps",
            "refresh_tokens_real", "refresh_tokens_exec",
            "reuse_tokens_real", "reuse_tokens_exec",
            "logit_tokens_real", "logit_tokens_exec")
SHARING = ("shared_hits", "shared_cow_promotes", "phys_slots_peak")


def serve_config(varlen: bool = True, kernels: bool = False,
                 sharing: bool = False, system: str = None) -> ServeConfig:
    """The reference tool's serve config; ``system`` (a baseline or
    dllm-serve) takes its profile over the padded base in place of
    ``varlen``'s choice."""
    serve = ServeConfig(
        max_num_batched_tokens=512, max_num_logits=64, block_size=8,
        steps_per_block=8, max_seq_len=128, max_slots=8,
        max_refresh_per_iter=2, logit_mode="chunked",
        varlen_pack=varlen, token_bucket=64, prefix_sharing=sharing)
    if system is not None:
        serve = system_profiles(dataclasses.replace(
            serve, varlen_pack=False))[system]
    if kernels:
        serve = dataclasses.replace(serve, use_flash_kernel=True,
                                    logit_mode="fused")
    return serve


def trace_prompts(cfg: ModelConfig, n: int, seed: int,
                  duplicate: bool = False) -> list:
    """The reference tool's prompts; ``duplicate`` pairs requests onto
    identical prompts (the rng stream drawn in full first)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size - 1, int(rng.integers(8, 48)))
               for _ in range(n)]
    if duplicate:
        prompts = [prompts[i // 2] for i in range(n)]
    return prompts


def serve_trace(cfg: ModelConfig, serve: ServeConfig, prompts, seed: int,
                warmup: bool, device, clock=None, params=None):
    """One eager serve of ``prompts`` (gen_len 16, all at t=0), on
    ``params`` (the reference's parameter tree as numpy arrays, each leaf
    cut to this rank's shard as it lands) or on weights drawn from
    ``seed``."""
    if params is not None:
        mesh, cut = M.active(), None
        if mesh is not None:
            cut = shard_cut(Rules(cfg, mesh, train=False), mesh)
        params = from_jax(params, cfg, device, cut=cut)
    eng = Engine(cfg, serve, params=params, seed=seed, device=device,
                 graphs=False, clock=clock)
    if warmup:
        eng.warmup()
    reqs = [eng.submit(p, gen_len=16, arrival=0.0, rid=i)
            for i, p in enumerate(prompts)]
    stats = eng.run()
    return eng, reqs, stats


def launch_counts() -> dict:
    """``{kernel: [launches, plain-version calls]}`` of this process's
    kernel wrappers."""
    from repro_torch.kernels import build
    return {n: [c.launches, c.plain_calls]
            for n, c in sorted(build.COUNTERS.items())}


def _record(eng, reqs, stats, pool: bool) -> dict:
    rec = dict(tokens=[np.asarray(r.output_tokens()) for r in reqs],
               stats={k: getattr(stats, k) for k in COUNTERS + SHARING},
               vtime=eng.vtime, mesh_devices=eng.mesh_devices,
               launches=launch_counts())
    if pool:
        rec["pool"] = [t.float().cpu().numpy()
                       for t in tree_leaves(eng.pool.full_cache())]
    return rec


def _mesh_rank(mesh, cfg, serve, prompts, seed, warmup, clock,
               params) -> dict:
    """A rank's serve; the pool is gathered on every rank (a collective)
    and returned by rank 0 only. The launch counts are the serve's: the
    rank's process runs nothing else."""
    t0 = time.perf_counter()
    eng, reqs, stats = serve_trace(cfg, serve, prompts, seed, warmup,
                                   mesh.device, clock, params)
    serve_s = time.perf_counter() - t0
    rec = _record(eng, reqs, stats, pool=True)
    if mesh.rank:
        rec.pop("pool")
    rec.update(serve_s=serve_s, collective_s=mesh.collective_s,
               collectives=mesh.collectives,
               param_bytes=sum(t.numel() * t.element_size()
                               for t in eng.params.parameters()),
               peak_bytes=(torch.cuda.max_memory_allocated(mesh.device)
                           if mesh.device.type == "cuda" else None))
    return rec


def compare(ref: dict, got: dict, n_slots: int, mesh_shape,
            sharing: bool) -> list:
    """The differences between a one-device record and a mesh record."""
    diffs = []
    if sharing:
        for name in SHARING:
            va, vb = ref["stats"][name], got["stats"][name]
            if va != vb:
                diffs.append(f"stats.{name}: {va} != {vb}")
        if got["stats"]["shared_hits"] == 0:
            diffs.append("sharing requested but no dedup hits — the check "
                         "proved nothing")
    if got["mesh_devices"] != int(np.prod(mesh_shape)):
        diffs.append(f"mesh collapsed to {got['mesh_devices']} devices")
    for rid, (a, b) in enumerate(zip(ref["tokens"], got["tokens"])):
        if not np.array_equal(a, b):
            diffs.append(f"token ids diverge on rid={rid}")
    for name in COUNTERS:
        va, vb = ref["stats"][name], got["stats"][name]
        if va != vb:
            diffs.append(f"stats.{name}: {va} != {vb}")
    for i, (la, lb) in enumerate(zip(ref["pool"], got["pool"])):
        la, lb = la[:, :n_slots], lb[:, :n_slots]
        if la.shape != lb.shape:
            diffs.append(f"pool leaf {i} shape {la.shape}!={lb.shape}")
        elif not pool_close(la, lb):
            err = float(np.abs(la - lb).max())
            diffs.append(f"pool leaf {i} max err {err:.2e}")
    return diffs


def pool_close(ref: np.ndarray, got: np.ndarray) -> bool:
    """The pool law: the reference's ``allclose(atol=1e-5, rtol=1e-5)``,
    its ``atol`` scaled by the leaf's largest magnitude where that exceeds
    1. A float32 sum's rounding error is a share of its terms' sizes, not
    of its result's, so a cache entry that sums large terms to a small
    value moves with the leaf's scale. A leaf within [-1, 1] is held to
    the reference's law exactly."""
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    return bool(np.allclose(ref, got, atol=1e-5 * scale, rtol=1e-5))


def pool_error(ref: dict, got: dict, n_slots: int) -> tuple:
    """(max |difference|, max |value| of the leaf that holds it) over the
    pools' real and scratch slots."""
    err = mag = 0.0
    for la, lb in zip(ref["pool"], got["pool"]):
        la, lb = la[:, :n_slots], lb[:, :n_slots]
        if la.shape == lb.shape and la.size:
            e = float(np.abs(la - lb).max())
            if e > err:
                err, mag = e, float(np.abs(la).max())
    return err, mag


def check(arch: str, mesh_shape, n: int = 5, seed: int = 0,
          varlen: bool = True, warmup: bool = False, kernels: bool = False,
          sharing: bool = False, device="cuda", colocate: bool = False,
          cfg: ModelConfig = None, clock=None, params=None,
          system: str = None) -> dict:
    """Serve the trace on one device, then on ``mesh_shape``, and compare.
    ``cfg`` replaces the reduced config of ``arch`` (the card's checks run
    a full-width one); ``params`` (a numpy parameter tree) replaces the
    weights drawn from ``seed``; ``clock`` the engines' clock; ``system``
    serves a system's profile (:func:`serve_config`). Returns the
    reference tool's record, with each run's seconds and the mesh ranks'
    collective seconds."""
    cfg = cfg if cfg is not None else reduced(ARCHS[arch])
    serve = serve_config(varlen, kernels, sharing, system)
    prompts = trace_prompts(cfg, n, seed, duplicate=sharing)
    # the one-device anchor first, in this process, its launches counted
    from repro_torch.kernels import build
    build.reset_counters()
    t0 = time.perf_counter()
    eng, reqs, stats = serve_trace(cfg, serve, prompts, seed, False, device,
                                   clock, params)
    ref = _record(eng, reqs, stats, pool=True)
    one_s = time.perf_counter() - t0
    del eng, reqs
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.empty_cache()
    mesh_serve = dataclasses.replace(serve, mesh_shape=tuple(mesh_shape))
    t0 = time.perf_counter()
    ranks = M.spawn(_mesh_rank, mesh_shape, device, cfg, mesh_serve, prompts,
                    seed, warmup, clock, params, colocate=colocate)
    mesh_s = time.perf_counter() - t0
    got = ranks[0]
    diffs = compare(ref, got, serve.max_slots + 1, mesh_shape, sharing)
    pool_err, pool_mag = pool_error(ref, got, serve.max_slots + 1)
    for r, rec in enumerate(ranks[1:], 1):
        for rid, (a, b) in enumerate(zip(got["tokens"], rec["tokens"])):
            if not np.array_equal(a, b):
                diffs.append(f"rank {r} token ids diverge on rid={rid}")
        if rec["stats"] != got["stats"]:
            diffs.append(f"rank {r} counters differ from rank 0's")
    plan_bytes = weight_bytes_per_device(cfg, mesh_shape)
    for r, rec in enumerate(ranks):
        if rec["param_bytes"] != plan_bytes:
            diffs.append(f"rank {r} holds {rec['param_bytes']} parameter "
                         f"bytes, the plan bills {plan_bytes} a device")
    return dict(
        arch=arch, varlen=serve.varlen_pack, system=system,
        mesh=list(mesh_shape),
        mesh_devices=got["mesh_devices"], n=n, kernels=kernels,
        kernels_active=bool(kernels), sharing=sharing,
        shared_hits=got["stats"]["shared_hits"],
        shared_cow_promotes=got["stats"]["shared_cow_promotes"],
        device=str(device), colocate=colocate, vtime=got["vtime"],
        one_device_s=one_s, mesh_s=mesh_s,
        rank_serve_s=[r["serve_s"] for r in ranks],
        rank_collective_s=[r["collective_s"] for r in ranks],
        rank_collectives=[r["collectives"] for r in ranks],
        plan_weight_bytes=plan_bytes,
        rank_param_bytes=[r["param_bytes"] for r in ranks],
        rank_peak_bytes=[r["peak_bytes"] for r in ranks],
        one_device_launches=ref["launches"],
        rank_launches=[r["launches"] for r in ranks],
        tokens=[t.tolist() for t in got["tokens"]], stats=got["stats"],
        pool_max_err=pool_err, pool_max_abs=pool_mag,
        ok=not diffs, diffs=diffs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--mesh", default=None,
                    help="'d,m' or 'p,d,m' (default: REPRO_MESH, else "
                         "1,2)")
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--padded", action="store_true",
                    help="check the padded path instead of the packed one")
    ap.add_argument("--warmup", action="store_true",
                    help="warm the mesh engine's entries first")
    ap.add_argument("--kernels", action="store_true",
                    help="the kernel paths on both runs (use_flash_kernel + "
                         "logit_mode=fused): the per-shard kernels against "
                         "the one-device kernel run")
    ap.add_argument("--sharing", action="store_true",
                    help="prefix sharing on both runs over duplicated "
                         "prompts: the ledger is device-count invariant")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda: one GPU a rank (NCCL), or every rank on one "
                         "with --colocate; cpu: gloo ranks on the host")
    ap.add_argument("--colocate", action="store_true",
                    help="every rank on one GPU, over gloo (a test "
                         "arrangement; with --device cuda)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    mesh = (M.parse_mesh(args.mesh) if args.mesh
            else (M.parse_mesh_env() or (1, 2)))
    res = check(args.arch, mesh, n=args.n, seed=args.seed,
                varlen=not args.padded, warmup=args.warmup,
                kernels=args.kernels, sharing=args.sharing,
                device=args.device, colocate=args.colocate)
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
