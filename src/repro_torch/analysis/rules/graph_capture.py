"""graph-capture: CUDA graph capture and ``torch.compile`` only in
``core/graphs.py`` (the counterpart of the reference's ``bare-jit``).

Every stage entry of the serving path is captured by
``core.graphs.StageGraphs``, which counts each capture in
``compile_counts``: the retrace sentinel's budget reads that count. A
capture or a compile anywhere else is uncounted: invisible to
``EngineStats`` and to the zero-post-warmup budget.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import PACKAGE, FileContext, Finding, Rule, \
    _dotted

HOME = f"{PACKAGE}/core/graphs.py"
_BANNED = ("torch.cuda.graph", "torch.cuda.CUDAGraph", "torch.compile",
           "torch.cuda.graphs")
_NAMES = ("CUDAGraph", "graph", "compile")


class GraphCaptureRule(Rule):
    name = "graph-capture"
    description = ("torch.cuda.graph / CUDAGraph / torch.compile only in "
                   "core/graphs.py (capture-counted entries)")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.path == HOME:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute):
                dotted = _dotted(node)
                if dotted in _BANNED:
                    yield self.finding(
                        ctx, node,
                        f"`{dotted}` outside core/graphs.py — capture "
                        "through core.graphs.StageGraphs so it is counted")
            elif (isinstance(node, ast.ImportFrom) and node.module
                  and node.module in ("torch.cuda", "torch",
                                      "torch.cuda.graphs")
                  and any(a.name in _NAMES for a in node.names)):
                yield self.finding(
                    ctx, node,
                    f"`from {node.module} import ...` of a capture or "
                    "compile entry — capture through core.graphs")
