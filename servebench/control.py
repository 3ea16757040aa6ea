"""The readings a correctness limit is set from, in one process: for each
of ``--workload``'s cells (comma-separated, of one configuration) and
each seed, the numbers the check compares for the program, and on the
first ``--control`` seeds of each cell the control's (the reference at
the next precision below the configuration's put in the program's place),
with its verdict by the same decision.

    python3 servebench/control.py --workload <cell>[,<cell>] \\
        --seeds 1,2,3 --seconds 30 --control 3

One set-up serves every window. Prints one JSON line a window. Benchmark
runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "servebench"), str(ROOT / "src")]

import torch  # noqa: E402

from sbench import execute, session, spec, window  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cells = [spec.load_cell(name, ROOT) for name in args.workload.split(",")]
    if len({c.config["name"] for c in cells}) != 1:
        print("control: the cells must share one configuration",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    log = lambda *a: print(*a, file=sys.stderr)  # noqa: E731
    sess = session.Session(cells[0], seeds[0], torch.device("cuda", 0),
                           log=log)
    print(json.dumps({"setup_s": time.perf_counter() - sess.t_start,
                      "slots": sess.built.slots, "kind": sess.kind}),
          flush=True)
    wins = [(c, i, sess.window(s, args.seconds, mix=c.traffic))
            for c in cells for i, s in enumerate(seeds)]
    sess.close()
    for c, i, w in wins:
        t0 = time.perf_counter()
        sess.draw(w.seed)
        v = execute.verify(c, w.run, sess.params, w.seed, log,
                           control=i < args.control)
        print(json.dumps({
            "cell": c.name, "seed": w.seed, "tok_s": window.tok_s(w.run),
            "correct": v["correct"],
            **{k: x[0] for k, x in v["checks"].items()},
            "control_correct": v.get("control_correct"),
            **{f"control_{k}": x[0]
               for k, x in v.get("control_checks", {}).items()},
            "order": v["order"], "control_order": v.get("control_order"),
            "finished": v["finished"], "rids": v["rids"],
            "check_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
