"""mesh-api: ``torch.distributed`` only in ``launch/mesh.py``.

The serving mesh (``launch.mesh``) is the one doorway to process groups
and collectives: it stages CUDA tensors for gloo, times every collective
and is the identity on a group of one. A module that imports or calls
``torch.distributed`` directly bypasses all three.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import PACKAGE, FileContext, Finding, Rule, \
    _dotted

HOME = f"{PACKAGE}/launch/mesh.py"
_BANNED = "torch.distributed"


def _banned(name: str) -> bool:
    return name == _BANNED or name.startswith(_BANNED + ".")


class MeshApiRule(Rule):
    name = "mesh-api"
    description = "torch.distributed only via launch/mesh.py"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.path == HOME:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                if _banned(node.module) or (
                        node.module == "torch"
                        and any(a.name == "distributed" for a in node.names)):
                    yield self.finding(
                        ctx, node,
                        f"direct `from {node.module} import ...` — use the "
                        "serving mesh (launch.mesh)")
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if _banned(alias.name):
                        yield self.finding(
                            ctx, node,
                            f"direct `import {alias.name}` — use "
                            "launch.mesh")
            elif isinstance(node, ast.Attribute):
                dotted = _dotted(node)
                if dotted is not None and _banned(dotted) and not isinstance(
                        ctx.parents.get(node), ast.Attribute):
                    yield self.finding(
                        ctx, node, f"direct `{dotted}` — use launch.mesh")
