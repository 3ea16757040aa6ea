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
(the captured graphs' shared memory pool, which the profiler's plan does not
bill; 0 without graphs). Keys whose feature the
port does not have yet carry the reference's "off" value:
``mesh_devices=1``, sharing and faults at zero.

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
import json
import os
import time
from typing import Optional

import numpy as np

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.base import ServeConfig
from repro_torch.core.baselines import size_slots, system_profiles
from repro_torch.core.budgeting import plan_memory
from repro_torch.core.engine import Engine
from repro_torch.core.request import State
from repro_torch.data.workloads import make_trace, trace_prompts


# the paper's Table 3 geometry, at which the profiler plans every run
PLAN_GEOMETRY = dict(max_seq_len=2048, max_num_batched_tokens=4000,
                     max_num_logits=2048)


def profile_slots(full_cfg, serve: ServeConfig, max_slots: int, hbm_gb: int):
    """The offline profiler (§4.2) on the full model at the plan geometry:
    monolithic logit reservations and dense caches buy fewer slots. Returns
    the plan and ``serve`` with ``max_slots`` clamped to it."""
    plan_serve = dataclasses.replace(serve, max_slots=max_slots,
                                     **PLAN_GEOMETRY)
    plan = plan_memory(full_cfg, plan_serve, hbm_gb << 30)
    sized = size_slots(full_cfg, plan_serve, hbm_gb << 30)
    return plan, dataclasses.replace(serve, max_slots=sized.max_slots)


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
              kernels: Optional[bool] = None,
              pipeline: bool = True,
              stream: bool = False,
              device: str = "cuda",
              n_layers: Optional[int] = None) -> dict:
    """The reference's ``run_serve`` on the port, with its defaults, and
    without the options of features not ported yet (mesh, faults, sharing,
    int8 KV); ``device`` picks where the engine runs; ``n_layers`` cuts the
    arch's depth (what is served and what the profiler plans)."""
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
        preempt_starvation_s=preempt_starvation_s, pipeline=pipeline)
    serve = system_profiles(base)[system]
    if kernels:
        serve = dataclasses.replace(serve, use_flash_kernel=True,
                                    logit_mode="fused")
    elif kernels is not None:
        serve = dataclasses.replace(serve, use_flash_kernel=False,
                                    logit_mode="chunked")
    trace = make_trace(workload, n, rps, seed=seed, scale=length_scale,
                       deadline_slack=deadline_slack)
    plan = None
    if size_by_profiler:
        plan, serve = profile_slots(full_cfg, serve, max_slots, hbm_gb)
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
    eng = Engine(cfg, serve, seed=seed, clock=clock, stream_cb=stream_cb,
                 device=device)
    warmup_s = eng.warmup()
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
        share_factor=1.0,
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
    )


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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = run_serve(args.arch, args.system, args.workload, args.rps, args.n,
                    use_reduced=not args.full, seed=args.seed, quiet=False,
                    queue_cap=args.queue_cap, queue_policy=args.queue_policy,
                    deadline_slack=args.deadline,
                    preempt_starvation_s=args.preempt_starvation,
                    kernels=True if args.kernels else None,
                    clock=args.clock, pipeline=not args.no_pipeline,
                    stream=args.stream, device=args.device)
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
