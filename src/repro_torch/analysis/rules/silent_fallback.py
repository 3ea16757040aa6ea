"""silent-fallback: every kernel-dispatch branch raises or is billed.

The honesty contract: a config that *asks* for the kernel paths
(``use_flash_kernel`` / ``use_flash_refresh`` / ``logit_mode``) either runs
them, or the system raises, and whichever path runs is billed as itself
in the modeled clock. A branch on one of these flags whose enclosing
function neither raises nor touches a billing marker (``_charge``, the
modeled clock's; ``require_divisible`` and ``kernel_partition_plan``, the
kernels' divisibility law; ``_check_kernel_path``, the card's refusal of
the plain fallbacks) is the anatomy of a silent fallback.

The memory-footprint flag ``kv_quant`` is held to the same contract: a
branch that quietly skips quantization would under-bill capacity
(``plan_memory`` converts it into slots), so the enclosing function must
raise or touch a quantization marker (``quant_mask``, the one leaf
predicate of billing and runtime, or its flattened ``quant_leaf_flags``;
``quantize_slot_leaves`` or ``dequantize_slot_leaves``).

Only ``if`` *statements* are examined — a ternary selecting a value is data
selection, not an execution-path fork.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import FileContext, Finding, Rule

FLAGS = ("use_flash_kernel", "use_flash_refresh", "logit_mode", "kv_quant")
MARKERS = ("_charge", "require_divisible", "kernel_partition_plan",
           "_check_kernel_path", "quant_mask", "quant_leaf_flags",
           "quantize_slot_leaves", "dequantize_slot_leaves")


def _flags_in(test: ast.AST):
    hits = set()
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr in FLAGS:
            hits.add(n.attr)
        elif isinstance(n, ast.Name) and n.id in FLAGS:
            hits.add(n.id)
    return hits


def _is_accounted(func: ast.AST) -> bool:
    """The enclosing function raises, or calls a billing marker, or IS one."""
    if getattr(func, "name", "") in MARKERS:
        return True
    for n in ast.walk(func):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Call):
            fn = n.func
            callee = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if callee in MARKERS:
                return True
    return False


class SilentFallbackRule(Rule):
    name = "silent-fallback"
    description = ("kernel-dispatch / memory-footprint flag branches must "
                   "raise or call a billing marker")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.If):
                continue
            hits = _flags_in(node.test)
            if not hits:
                continue
            func = ctx.enclosing_function(node)
            if func is not None and _is_accounted(func):
                continue
            yield self.finding(
                ctx, node,
                f"branch on {sorted(hits)} with no raise and no billing "
                "marker in the enclosing function — a silent kernel "
                "fallback")
