"""Where the serving time goes on the card: ``Engine.run`` under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile [--arch zamba2-7b]
        [--system sparse-dllm] [--n 8] [--out F]

Serves the full arch (default llada-8b; random bfloat16 weights from a
seed) through a system's profile (default dllm-serve) with the kernels, the
configuration chip_smoke.py drives (slots sized by the offline profiler at
the card's memory; the launcher's defaults, so the pipelined loop and, on
the card, the captured stage entries), once to warm and once under the
profiler (CUDA activity only: the script reads device events alone).
The profiled window is ``Engine.run`` alone: engine construction (weights
drawn on the device) and warmup (the graphs' captures) stay outside, so the
busy time and the run's wall clock cover the same span.
Prints one JSON object: the device seconds summed over the profiled run's
kernels and copies (self time: concurrent kernels count twice, so no idle
share is derived from it); the profiled run's device time by stage and the
device's gaps between iterations from the engine's ``iter_log`` (CUDA
events: ``refresh_dev_s``, ``reuse_dev_s``, ``logit_dev_s``,
``gap_dev_s``) and the host's landing of the ids (``land_s``); device time
by group — the port's kernels, matrix products, device<->host copies,
everything else — and by kernel name; and the host split, ``warmup_s``
and the graph replays of the profiled serve.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.engine import Engine
from repro_torch.launch.serve import run_serve

SERVE_KW = dict(max_seq_len=256, block_size=8, max_slots=12,
                max_num_batched_tokens=1024, max_num_logits=128)
GROUPS = (("flash_varlen (self + cross)", ("varlen_attention_kernel",
                                           "varlen_merge_kernel")),
          ("packed_flash_attention", ("packed_attention_kernel",)),
          ("flash_refresh", ("refresh_attention_kernel",)),
          ("head_score (varlen + padded)", ("head_score_kernel",)),
          ("fused_logit_argmax", ("logit_partial_kernel",
                                  "logit_merge_kernel")),
          ("ssm_segment_scan", ("ssm_",)),
          ("matmul", ("nvjet", "gemm", "gemv", "xmma", "cutlass")),
          ("memcpy", ("Memcpy", "Memset")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


@contextlib.contextmanager
def _profiled_run(box: dict):
    """Profile every ``Engine.run`` inside the block, and nothing else:
    the device is drained before the window opens and before it closes."""
    run = Engine.run

    def wrapped(self, *args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run(self, *args, **kwargs)
            torch.cuda.synchronize()
            box["wall"] = time.perf_counter() - t0
        box["prof"] = prof
        box["rows"] = list(self.stats.iter_log)
        return out
    Engine.run = wrapped
    try:
        yield box
    finally:
        Engine.run = run


def profile_serve(arch: str, n: int, seed: int = 0,
                  system: str = "dllm-serve") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the profile measures the card; no CUDA device")
    kw = dict(use_reduced=False, kernels=True, clock="wall", seed=seed,
              size_by_profiler=True, device="cuda",
              hbm_gb=torch.cuda.get_device_properties(0).total_memory >> 30,
              **SERVE_KW)
    warm = run_serve(arch, system, "livebench", 50.0, n, **kw)
    torch.cuda.synchronize()
    with _profiled_run({}) as box:
        res = run_serve(arch, system, "livebench", 50.0, n, **kw)
    wall = box["wall"]
    by_name = {}
    for e in box["prof"].key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            by_name[e.key] = (e.self_device_time_total / 1e3, e.count)
    groups = defaultdict(float)
    for name, (ms, _) in by_name.items():
        groups[group_of(name)] += ms
    busy_s = sum(ms for ms, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    rows = box["rows"]
    total = lambda key: sum(r[key] or 0.0 for r in rows)  # noqa: E731
    return dict(
        arch=arch, system=system, card=torch.cuda.get_device_name(0),
        n_requests=n,
        iterations=res["iterations"], committed_tokens=res["committed_tokens"],
        profiled_wall_s=wall, device_busy_s=busy_s,
        stage_dev_s={k: total(f"{k}_dev_s")
                     for k in ("refresh", "reuse", "logit")},
        gap_dev_s=total("gap_dev_s"), land_s=total("land_s"),
        unprofiled_wall_clock_s=warm["wall_clock_s"],
        unprofiled_wall_tok_s=warm["wall_tok_s"],
        host_plan_s=res["host_plan_s"], host_fill_s=res["host_fill_s"],
        sync_wait_s=res["sync_wait_s"], warmup_s=res["warmup_s"],
        unprofiled_host_fill_s=warm["host_fill_s"],
        pipeline=res["pipeline"], dispatched_ahead=res["dispatched_ahead"],
        graph_replays=sum(res.get("graph_replays", {}).values()),
        refresh_waste=res["refresh_waste"], reuse_waste=res["reuse_waste"],
        logit_waste=res["logit_waste"],
        padded_refresh_calls=res["padded_refresh_calls"],
        padded_reuse_calls=res["padded_reuse_calls"],
        groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=k[:120], ms=v[0], count=v[1]) for k, v in top])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--system", default="dllm-serve",
                    choices=["dllm-serve", "sparse-dllm", "fast-dllm",
                             "dllm-cache"])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = profile_serve(args.arch, args.n, system=args.system)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
