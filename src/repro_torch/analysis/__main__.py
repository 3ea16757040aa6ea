"""CLI: ``python -m repro_torch.analysis [--strict] [--grid-audit]
[--archs ...] [--json F]``.

Default runs the AST linter over ``src/repro_torch``; ``--grid-audit``
adds the grid sweep (every arch × serving mesh shape, the stages on
meta tensors). ``--strict`` exits non-zero on any finding or error (the
gate); without it the run is report-only. ``--json`` writes the combined
findings. Nothing here touches a device.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="invariant analyzer: AST lint + grid audit")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any lint finding or audit error")
    ap.add_argument("--grid-audit", action="store_true",
                    help="also run the grid audit (arch x mesh sweep)")
    ap.add_argument("--archs", nargs="*", default=None,
                    help="restrict the grid audit to these archs")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the combined JSON findings")
    args = ap.parse_args(argv)

    from repro_torch.analysis.lint import run_lint
    report = run_lint()
    out = {"lint": report.to_dict()}
    print(f"lint: {report.files_scanned} files, "
          f"{len(report.findings)} finding(s), "
          f"{len(report.suppressed)} suppressed")
    for f in report.findings:
        print(f"  {f}")

    audit_ok = True
    if args.grid_audit:
        from repro_torch.analysis.trace_audit import run_grid_audit
        audit = run_grid_audit(archs=args.archs)
        out["grid_audit"] = audit.to_dict()
        n_ok = sum(c.status == "ok" for c in audit.cells)
        n_raise = sum(c.status == "expected-raise" for c in audit.cells)
        print(f"grid audit: {len(audit.cells)} cells — {n_ok} ok, "
              f"{n_raise} expected-raise, {len(audit.errors)} error(s) "
              f"in {audit.elapsed_s:.1f}s")
        for c in audit.errors:
            print(f"  ERROR {c.arch} x {c.mesh}: {c.detail}")
        audit_ok = audit.ok

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=2, sort_keys=True)
        print(f"wrote {args.json}")

    failed = not report.ok or not audit_ok
    if failed and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
