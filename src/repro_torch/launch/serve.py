"""Serving launcher: run the port's engine over a synthetic workload under
one of the paper's serving systems and print the reference launcher's JSON
keys.

On the card (the default device), with the kernels, full width:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \\
      --system dllm-serve --kernels --full --clock wall

On the CPU, the kernels' plain versions at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \\
      --system sparse-dllm --kernels --device cpu

``--system`` takes every profile of ``core.baselines.system_profiles``:
dllm-serve (phase scheduler, token-packed) and the three baselines
fast-dllm, dllm-cache and sparse-dllm (request-level scheduler, padded).
Without ``--kernels`` a system runs its profile's own flags: the plain
attention fallbacks, which the engine takes on the CPU only, and the
profile's logit mode (monolithic for the baselines, chunked for
dllm-serve), which runs on the card too. ``--arch`` takes any arch of
``repro_torch.configs.ARCHS``, and every system serves each: the dense
archs, the scan families (mamba2-130m, zamba2-7b), the MoE archs
(phi3.5-moe-42b-a6.6b, qwen3-moe-235b-a22b) and the modality frontends
(internvl2-76b, musicgen-medium: each request's frontend payload is drawn
from the engine's seed, as in the reference).
``run_serve(n_layers=...)`` cuts a full config's depth, for an arch whose
weights do not fit the card (the profiler then plans the cut config).

As in the reference, the offline memory profiler sizes each system's slots
by default (``size_by_profiler=True`` at ``hbm_gb=24``), planned on the full
config at the paper's geometry whatever size is served, and the engine runs
the pipelined loop (``--no-pipeline``: the synchronous one; ``--stream``
prints each commit event at its sync). On the card every (stage, bucket)
entry is captured as a CUDA graph in warmup and replayed (the engine's
``graphs=False`` runs the same entries eagerly, as the oracle).
``compile_counts`` counts the entries built (captures, on the card), and the
JSON adds ``graph_replays`` (replays per entry) and ``graph_pool_bytes``
(the captured graphs' shared memory pool; 0 without graphs). Keys whose
feature the port does not have carry the reference's "off" value.

Mesh serving, as the reference's launcher: ``--mesh d,m`` or ``--mesh
p,d,m`` (or ``REPRO_MESH``; ``--mesh none`` forces one device) serves on a
``(data, model)`` or ``(pod, data, model)`` mesh, one rank a device (``launch.mesh.spawn``: NCCL on
the card, one GPU a rank; gloo on the CPU), each sized and billed per
device; rank 0's JSON carries ``mesh_shape`` and ``mesh_devices``. A mesh
larger than the visible GPUs raises ``ValueError`` before any rank starts.
The NCCL arrangement is unverified: no run of it has had two GPUs.

The device bill (``core.budgeting.bill_device``): after warmup a profiler-
sized serve bills what it holds on the card — the engine's weights (a
reduced serve holds far less than the full config the plan sized), the
engine's slot pool at the serving geometry (the plan sizes slots at the
paper's larger geometry, ``PLAN_GEOMETRY``), the graph pool (billed
against the plan's activation reservation, the larger of the two), the
stage entries' device staging, and, for an eager serve on the card, the
measured logit-stage peak in place of the plan's logit term — and holds
the sum against ``hbm_gb`` less the guard band. A serve that exceeds it is
re-sized once (``ceil(excess / slot_bytes)`` slots fewer, the engine built
and warmed again on the same weights); one that still exceeds it raises
``ValueError``. The JSON's ``device_bill`` holds the final bill, the
plan's pool for the same slots beside it, the slot count it was re-sized
from (None: it fit) and each engine's warmup seconds.

Robustness and the memory multipliers, as in the reference: ``--faults
SEED`` serves under ``FaultPlan.seeded(SEED)`` (dispatch faults retried
with backoff, allocation faults, memory-pressure steals, slow
iterations); ``--sharing`` turns on content-addressed prefix sharing in
the slot pool (the trace is drawn before the plan, so its measured
``share_factor`` reaches the profiler); ``--kv-quant int8`` stores the KV
slots as int8 with per-(layer, slot) scales.

Admission, as in the reference: ``--queue-cap`` bounds the waiting queue
(0: unbounded) and ``--queue-policy`` rejects a new arrival or evicts the
oldest waiter when it is full; ``--deadline`` gives every request a
deadline that many trace seconds after its arrival (expired waiters are
shed); ``--preempt-starvation`` preempts a resident for a waiter starved
that long (0: never).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.base import ServeConfig
from repro_torch.core.baselines import size_slots, system_profiles
from repro_torch.core.budgeting import (bill_device, measure_logit_peak,
                                        plan_memory)
from repro_torch.core.engine import Engine
from repro_torch.core.faults import FaultPlan
from repro_torch.core.request import State
from repro_torch.data.workloads import (make_trace, prefix_share_factor,
                                        trace_prompts)
from repro_torch.launch import mesh as M
from repro_torch.params import param_bytes


# the paper's Table 3 geometry, at which the profiler plans every run
PLAN_GEOMETRY = dict(max_seq_len=2048, max_num_batched_tokens=4000,
                     max_num_logits=2048)


def profile_slots(full_cfg, serve: ServeConfig, max_slots: int, hbm_gb: int,
                  share_factor: float = 1.0):
    """The offline profiler (§4.2) on the full model at the plan geometry:
    monolithic logit reservations and dense caches buy fewer slots, sharing
    (``share_factor``) and int8 slots buy more. Returns the plan and
    ``serve`` with ``max_slots`` clamped to its physical capacity."""
    plan_serve = dataclasses.replace(serve, max_slots=max_slots,
                                     **PLAN_GEOMETRY)
    plan = plan_memory(full_cfg, plan_serve, hbm_gb << 30,
                       share_factor=share_factor)
    sized = size_slots(full_cfg, plan_serve, hbm_gb << 30,
                       share_factor=share_factor)
    return plan, dataclasses.replace(serve, max_slots=max(1, sized.max_slots))


def device_bill(eng: Engine, plan, full_cfg, hbm_bytes: int):
    """The bill of a warmed engine against the plan that sized it: the
    weights it holds (on a mesh, this rank's shard; a reduced serve's are
    not the planned full config's), its slot pool (on a mesh, the rows
    this device holds), graph pool and staging bytes, and for an eager
    engine on the card the measured logit peak of its C1 mode at the plan
    geometry."""
    peak = None
    if eng.device.type == "cuda" and not eng.graphs.capture:
        plan_serve = dataclasses.replace(eng.serve, **PLAN_GEOMETRY)
        peak = measure_logit_peak(
            full_cfg, plan_serve, plan_serve.max_num_batched_tokens,
            eng.device)[eng.serve.logit_mode]
    return bill_device(plan, hbm_bytes, eng.serve.max_slots,
                       eng.pool.slot_bytes(),
                       graph_pool_bytes=eng.graphs.pool_bytes(),
                       staging_bytes=eng.graphs.staging_bytes(),
                       logit_peak=peak, pool_rows=eng.pool.rows,
                       weights_bytes=param_bytes(eng.params))


def fit_to_budget(build, serve: ServeConfig, plan, full_cfg,
                  hbm_bytes: int):
    """Build and warm an engine for ``serve`` (``build(serve, params)``
    returns the engine and its warmup seconds) and bill it. One that does
    not fit is re-sized once: ``ceil(excess / slot_bytes)`` slots fewer,
    built again on the same weights (the graph pool only shrinks with
    fewer slots and buckets). Returns ``(engine, bill, resized_from,
    warmup seconds of each engine built)``; raises ``ValueError`` naming
    every figure when the re-sized serve still does not fit."""
    eng, warmup_s = build(serve, None)
    warmups = [warmup_s]
    bill = device_bill(eng, plan, full_cfg, hbm_bytes)
    if bill.fits:
        return eng, bill, None, warmups
    resized_from = serve.max_slots
    serve = dataclasses.replace(serve,
                                max_slots=serve.max_slots - bill.slots_over)
    if serve.max_slots < 1:
        raise ValueError(_refusal(bill, resized_from))
    params, on_card = eng.params, eng.device.type == "cuda"
    del eng
    gc.collect()
    if on_card:
        import torch
        torch.cuda.empty_cache()
    eng, warmup_s = build(serve, params)
    warmups.append(warmup_s)
    bill = device_bill(eng, plan, full_cfg, hbm_bytes)
    if not bill.fits:
        raise ValueError(_refusal(bill, resized_from))
    return eng, bill, resized_from, warmups


def _refusal(bill, resized_from: int) -> str:
    return (f"serve does not fit the card's budget even re-sized from "
            f"{resized_from} to {bill.slots} slots: weights "
            f"{bill.weights_bytes} + kv pool {bill.kv_pool_bytes} + "
            f"max(activations {bill.activation_bytes}, graph pool "
            f"{bill.graph_pool_bytes}) + staging {bill.staging_bytes} = "
            f"{bill.total_bytes} B against {bill.budget_bytes} B (the "
            f"budget less its guard band; excess {bill.excess_bytes} B, "
            f"{bill.slot_bytes} B a slot)")


def run_serve(arch: str, system: str, workload: str, rps: float, n: int,
              use_reduced: bool = True, seed: int = 0,
              max_seq_len: int = 256, block_size: int = 8,
              steps_per_block: int = 8, max_slots: int = 12,
              max_num_batched_tokens: int = 1024, max_num_logits: int = 128,
              time_scale: float = 1.0, length_scale: float = 0.15,
              size_by_profiler: bool = True, hbm_gb: int = 24,
              clock: str = "modeled", quiet: bool = True,
              queue_cap: int = 0, queue_policy: str = "reject",
              deadline_slack: float = float("inf"),
              preempt_starvation_s: float = 0.0,
              fault_seed: Optional[int] = None,
              kernels: Optional[bool] = None,
              prefix_sharing: bool = False,
              kv_quant: str = "none",
              pipeline: bool = True,
              stream: bool = False,
              device: str = "cuda",
              n_layers: Optional[int] = None,
              mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    """The reference's ``run_serve`` on the port, with its defaults;
    ``device`` picks where the engine runs; ``n_layers`` cuts the arch's
    depth (what is served and what the profiler plans). A profiler-sized
    serve is billed on the device after warmup, and re-sized or refused
    when it does not fit. ``mesh_shape`` serves on a ``(data, model)`` or
    ``(pod, data, model)`` mesh: the call spawns one rank a device, each
    runs this function, and rank 0's result comes back."""
    if mesh_shape:
        mesh_shape = tuple(int(d) for d in mesh_shape)
        M.check_devices(mesh_shape, device)
        if math.prod(mesh_shape) > 1 and M.active() is None:
            kw = dict(locals())         # every argument of this call
            return M.spawn(_serve_rank, mesh_shape, device, kw)[0]
        if M.active() is not None:
            device = M.active().device
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    full_cfg = cfg
    if use_reduced:
        cfg = reduced(cfg)
    base = ServeConfig(
        max_num_batched_tokens=max_num_batched_tokens,
        max_num_logits=max_num_logits, block_size=block_size,
        steps_per_block=steps_per_block, max_seq_len=max_seq_len,
        max_slots=max_slots, max_refresh_per_iter=4,
        queue_cap=queue_cap, queue_policy=queue_policy,
        preempt_starvation_s=preempt_starvation_s,
        prefix_sharing=prefix_sharing, kv_quant=kv_quant, pipeline=pipeline,
        mesh_shape=mesh_shape or None)
    serve = system_profiles(base)[system]
    if kernels:
        serve = dataclasses.replace(serve, use_flash_kernel=True,
                                    logit_mode="fused")
    elif kernels is not None:
        serve = dataclasses.replace(serve, use_flash_kernel=False,
                                    logit_mode="chunked")
    # the trace first: the profiler's sharing-aware sizing reads its
    # measured share factor
    trace = make_trace(workload, n, rps, seed=seed, scale=length_scale,
                       deadline_slack=deadline_slack)
    share = prefix_share_factor(trace) if serve.prefix_sharing else 1.0
    plan = None
    if size_by_profiler:
        plan, serve = profile_slots(full_cfg, serve, max_slots, hbm_gb,
                                    share_factor=share)
    stream_cb = None
    if stream:
        # one event per request per iteration, fired at its sync: the first
        # host-side sight of the token values
        def stream_cb(ev):
            if not quiet:
                tok = ev["tokens"][:4]
                print(f"  stream rid={ev['rid']} block={ev['block_idx']} "
                      f"+{ev['n_committed']} tok "
                      f"{'FIN ' if ev['finished'] else ''}{tok}...")

    def build(serve, params=None):
        # a fresh plan a run: a FaultPlan is consumed as it serves
        faults = (FaultPlan.seeded(fault_seed) if fault_seed is not None
                  else None)
        eng = Engine(cfg, serve, params=params, seed=seed, clock=clock,
                     faults=faults, stream_cb=stream_cb, device=device)
        return eng, eng.warmup()

    bill = resized_from = None
    if plan is None:
        eng, warmup_s = build(serve, None)
        warmups = [warmup_s]
    else:
        eng, bill, resized_from, warmups = fit_to_budget(
            build, serve, plan, full_cfg, hbm_gb << 30)
        serve, warmup_s = eng.serve, warmups[-1]
    prompts = trace_prompts(trace, cfg.vocab_size, seed=seed)
    reqs = []
    for i, (t, p) in enumerate(zip(trace, prompts)):
        gl = min(t.gen_len, max_seq_len - len(p) - block_size)
        gl = max(block_size, gl)
        pl = min(len(p), max_seq_len - gl - block_size)
        reqs.append(eng.submit(p[:pl], gen_len=gl, arrival=t.arrival, rid=i,
                               deadline=t.deadline))
    t_run0 = time.perf_counter()
    stats = eng.run(time_scale=time_scale, quiet=quiet)
    host_elapsed_s = time.perf_counter() - t_run0
    fin = [r for r in reqs if r.state == State.FINISHED]
    lats = np.array([r.latency for r in fin]) if fin else np.zeros(1)
    good_tokens = sum(r.gen_len for r in fin if r.met_deadline)
    return dict(
        system=system, workload=workload, rps=rps, n=n,
        throughput_tok_s=stats.throughput,
        goodput_tok_s=good_tokens / max(stats.wall_time, 1e-9),
        committed_tokens=stats.committed_tokens,
        wall_time=stats.wall_time,
        n_submitted=stats.submitted,
        n_finished=stats.finished,
        n_shed=stats.shed,
        n_rejected=stats.rejected,
        shed_deadline=stats.shed_deadline,
        shed_queue=stats.shed_queue,
        rejected_oversized=stats.rejected_oversized,
        rejected_queue_full=stats.rejected_queue_full,
        n_preemptions=stats.preemptions,
        recomputed_tokens=stats.recomputed_tokens,
        dispatch_retries=stats.dispatch_retries,
        alloc_fault_iters=stats.alloc_fault_iters,
        avg_latency=float(lats.mean()),
        p50_latency=float(np.percentile(lats, 50)),
        p99_latency=float(np.percentile(lats, 99)),
        latency_std=float(lats.std()),
        tail_span=float(lats.max() - lats.min()),
        refresh_steps=stats.refresh_steps,
        reuse_steps=stats.reuse_steps,
        deferred=stats.deferred_steps,
        peak_query_tokens=stats.peak_query_tokens,
        refresh_tokens_real=stats.refresh_tokens_real,
        refresh_tokens_exec=stats.refresh_tokens_exec,
        refresh_waste=stats.refresh_waste,
        reuse_tokens_real=stats.reuse_tokens_real,
        reuse_tokens_exec=stats.reuse_tokens_exec,
        reuse_waste=stats.reuse_waste,
        logit_tokens_real=stats.logit_tokens_real,
        logit_tokens_exec=stats.logit_tokens_exec,
        logit_waste=stats.logit_waste,
        packed_refresh_calls=stats.packed_refresh_calls,
        padded_refresh_calls=stats.padded_refresh_calls,
        packed_reuse_calls=stats.packed_reuse_calls,
        padded_reuse_calls=stats.padded_reuse_calls,
        warmup_s=warmup_s,
        compile_counts=dict(stats.compile_counts),
        compiles_warmup=stats.compiles_warmup,
        compiles_post_warmup=stats.compiles_post_warmup,
        clock=clock,
        pipeline=serve.pipeline,
        iterations=stats.iterations,
        wall_clock_s=host_elapsed_s,
        wall_tok_s=stats.committed_tokens / max(host_elapsed_s, 1e-9),
        host_plan_s=stats.host_plan_s,
        host_fill_s=stats.host_fill_s,
        sync_wait_s=stats.sync_wait_s,
        overlapped_host_s=stats.overlapped_host_s,
        overlap_frac=stats.overlap_frac,
        dispatched_ahead=stats.dispatched_ahead,
        streamed_events=stats.streamed_events,
        host_profile=int(os.environ.get("REPRO_HOST_PROFILE", "0") or "0"),
        max_slots=serve.max_slots,
        prefix_sharing=serve.prefix_sharing,
        kv_quant=serve.kv_quant,
        share_factor=share,
        shared_hits=stats.shared_hits,
        shared_cow_promotes=stats.shared_cow_promotes,
        phys_slots_peak=stats.phys_slots_peak,
        plan_slots_logical=plan.max_slots if plan else None,
        plan_slots_phys=plan.phys_slots if plan else None,
        plan_slot_bytes=plan.slot_bytes if plan else None,
        mesh_shape=list(serve.mesh_shape) if serve.mesh_shape else None,
        mesh_devices=eng.mesh_devices,
        kernels_active=eng.kernels_active,
        refresh_tokens_exec_per_device=stats.refresh_tokens_exec
        / eng.work_split,
        reuse_tokens_exec_per_device=stats.reuse_tokens_exec
        / eng.work_split,
        logit_tokens_exec_per_device=stats.logit_tokens_exec
        / eng.work_split,
        graph_replays=dict(stats.graph_replays),
        graph_pool_bytes=eng.graphs.pool_bytes(),
        device_bill=None if bill is None else dict(
            bill.as_dict(), resized_from=resized_from, warmup_s=warmups),
    )


def _serve_rank(mesh, kw: dict) -> dict:
    """One rank of a mesh serve: :func:`run_serve` on the rank's device."""
    return run_serve(**kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b", choices=list_archs())
    ap.add_argument("--system", default="dllm-serve",
                    choices=["dllm-serve", "sparse-dllm", "fast-dllm",
                             "dllm-cache"])
    ap.add_argument("--workload", default="livebench")
    ap.add_argument("--rps", type=float, default=1.0)
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the full config (default reduced)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bounded waiting queue (0 = unbounded)")
    ap.add_argument("--queue-policy", default="reject",
                    choices=["reject", "evict"],
                    help="full-queue backpressure: reject new vs evict oldest")
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="per-request deadline slack in trace seconds "
                         "(inf = none); expired waiters are shed")
    ap.add_argument("--preempt-starvation", type=float, default=0.0,
                    help="starvation threshold (s) that triggers "
                         "preempt-and-requeue (0 = disabled)")
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="serve under FaultPlan.seeded(SEED) (chaos mode)")
    ap.add_argument("--sharing", action="store_true",
                    help="content-addressed prefix sharing in the slot pool "
                         "(copy-on-write on divergence; same ids as without)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="KV slot storage (int8: per-(layer, slot) abs-max "
                         "scales, dequantized at the Reuse KV load)")
    ap.add_argument("--kernels", action="store_true",
                    help="the kernel paths (use_flash_kernel + "
                         "logit_mode=fused) on top of the system profile; "
                         "what the card runs")
    ap.add_argument("--clock", default="modeled", choices=["modeled", "wall"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="the synchronous loop (sync every iteration) in "
                         "place of the dispatch-ahead pipelined loop; same "
                         "ids, counters and modeled clock")
    ap.add_argument("--stream", action="store_true",
                    help="print a commit event per request at each "
                         "iteration's sync")
    ap.add_argument("--mesh", default="env",
                    help="serving mesh: 'd,m', 'p,d,m', 'none', or 'env' "
                         "(REPRO_MESH, else none); one rank a device")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = run_serve(args.arch, args.system, args.workload, args.rps, args.n,
                    use_reduced=not args.full, seed=args.seed, quiet=False,
                    queue_cap=args.queue_cap, queue_policy=args.queue_policy,
                    deadline_slack=args.deadline,
                    preempt_starvation_s=args.preempt_starvation,
                    fault_seed=args.faults,
                    kernels=True if args.kernels else None,
                    prefix_sharing=args.sharing, kv_quant=args.kv_quant,
                    clock=args.clock, pipeline=not args.no_pipeline,
                    stream=args.stream, device=args.device,
                    mesh_shape=M.parse_mesh(args.mesh))
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
