"""multi-sync: at most ONE host sync per function, annotated or not.

The pipelined serving loop's contract is one deferred device read per
engine iteration. The ``host-sync`` rule makes each sync explicit, but a
pragma on every line would still let a function accumulate several
"sanctioned" stalls. This rule counts sync calls per enclosing function
and flags every one beyond the first, REGARDLESS of
``# lint: allow(host-sync)`` pragmas (the pragma names a different rule).
Fixing a finding means restructuring to a single transfer, not adding an
annotation.

Scope mirrors ``host-sync``. Whole-file exemptions go through the
ALLOWLIST under this rule's own name.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import FileContext, Finding, Rule
from repro_torch.analysis.rules.host_sync import (_EXEMPT_PREFIXES,
                                                  is_sync_call)


class MultiSyncRule(Rule):
    name = "multi-sync"
    description = ("at most one host sync per function — a second one in "
                   "the same function is a pipeline stall even when each "
                   "line is individually annotated")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.path.startswith(_EXEMPT_PREFIXES):
            return
        by_scope = {}
        for node in ast.walk(ctx.tree):
            if is_sync_call(node):
                scope = ctx.enclosing_function(node)
                by_scope.setdefault(scope, []).append(node)
        for scope, calls in by_scope.items():
            if len(calls) < 2:
                continue
            calls.sort(key=lambda n: (n.lineno, n.col_offset))
            where = (f"`{scope.name}`" if scope is not None
                     else "module scope")
            for extra in calls[1:]:
                yield self.finding(
                    ctx, extra,
                    f"{len(calls)} host syncs in {where} (first at line "
                    f"{calls[0].lineno}) — one deferred read per "
                    "iteration; batch the transfers into one")
