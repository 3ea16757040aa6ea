"""host-sync: device→host reads only at annotated sync points.

The serving engine's pipelined loop reads the device once per iteration
(its queued ``HostResult``), and a graphed stage cannot read the device
at all while it is captured. Any other ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()`` or ``synchronize()`` (``torch.cuda.synchronize``,
``Event.synchronize``) in library code is a hidden stall: annotate the
sync point with ``# lint: allow(host-sync)`` and say why, or keep the
value on the device. A host tensor's ``.numpy()`` is no device read, but
the rule cannot tell: annotate it.

Scope: ``launch/`` (the CLI harnesses print results: syncing is their
job) and the analysis package itself are exempt by path.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import PACKAGE, FileContext, Finding, Rule, \
    _dotted

_EXEMPT_PREFIXES = (f"{PACKAGE}/launch/", f"{PACKAGE}/analysis/")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


def is_sync_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS)


class HostSyncRule(Rule):
    name = "host-sync"
    description = ("device→host reads (.item, .tolist, .cpu, .numpy, "
                   "synchronize) only at annotated sync points")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.path.startswith(_EXEMPT_PREFIXES):
            return
        for node in ast.walk(ctx.tree):
            if is_sync_call(node):
                what = _dotted(node.func) or f".{node.func.attr}"
                yield self.finding(
                    ctx, node,
                    f"`{what}()` is a host sync — keep the value on the "
                    "device or annotate the sync point")
