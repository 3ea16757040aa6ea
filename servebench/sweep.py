"""The knee sweep of a rate cell, once, in one process: the cell's mix at
each of ``--rates`` base rates, without residents, one window each.

    python3 servebench/sweep.py --workload <cell> --rates 0.6,0.9,1.2 \\
        --seconds 40 --seed 1

Prints one JSON line a rate: tokens a second against the offered load,
``block_p95_s``, ``first_block_p90_s``, the time-weighted mean of running
requests over the window's second half, and the requests due in the
window still waiting at its end (a backlog that grows).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "servebench"), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbench import session, spec, window  # noqa: E402


def mean_running(samples, t0: float, t1: float) -> float:
    """Time-weighted mean of (t, running) samples over [t0, t1)."""
    tot = area = 0.0
    for (t, n), (u, _) in zip(samples, samples[1:] + [(t1, 0)]):
        a, b = max(t, t0), min(u, t1)
        if b > a:
            area += n * (b - a)
            tot += b - a
    return area / tot if tot else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    sess = session.Session(cell, args.seed, torch.device("cuda", 0))
    print(json.dumps({"setup_s": time.perf_counter() - sess.t_start,
                      "slots": sess.built.slots,
                      "kind": sess.kind}), flush=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(cell.traffic, rps=rate, residents=0)
        w = sess.window(args.seed, args.seconds, mix, count_running=True)
        r, W = w.run, args.seconds
        due = [q for q in r.reqs if q.due < W]
        print(json.dumps({
            "rps": rate,
            "offered_tok_s": sum(q.gen_len for q in due) / W,
            "tok_s": window.tok_s(r),
            "block_p95_s": window.percentile(window.block_latencies(
                r.events, r.reqs, r.mask_id, W), 95),
            "block_p50_s": window.percentile(window.block_latencies(
                r.events, r.reqs, r.mask_id, W), 50),
            "first_block_p90_s": window.percentile(
                window.first_block_latencies(r.events, r.reqs, r.mask_id, W),
                90),
            "mean_running_2nd_half": mean_running(w.running, W / 2, W),
            "max_running": max((n for _, n in w.running), default=0),
            "due": len(due), "waiting_at_end": w.waiting_at_end,
            "iterations": len(r.rows),
            "steps_per_iter": float(np.mean(
                [x["n_refresh"] + x["n_reuse"] for x in r.rows]))
            if r.rows else None}), flush=True)
    sess.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
