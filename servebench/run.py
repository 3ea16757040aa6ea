"""Run one cell of the serving benchmark once and print its result line.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: ``BENCHMARK.json`` names the cell's
configuration and traffic mix, found under ``servebench/``. Set-up (weights
drawn on the card from the seed, the engine built, warmed and billed, the
requests submitted) is timed from the start of this script to the window's
opening as ``setup_s``. The last line of standard output is one JSON
object; the numbers the check compared, each beside its limit, are the
last lines of standard error. Needs a CUDA card: without one it exits 2
and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at a
# fixed path
_CACHE = ROOT / "build" / "servebench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(_CACHE / "inductor")
sys.path[:0] = [str(ROOT / "servebench"), str(ROOT / "src")]

import torch  # noqa: E402

from sbench import execute, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"servebench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute.execute(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    bad = execute.forbidden_modules()
    if bad:
        print(f"servebench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    sys.stdout.flush()
    for line in execute.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
