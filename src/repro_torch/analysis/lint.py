"""AST invariant linter: framework, pragma handling, and the allowlist, as
``repro.analysis.lint``.

Rules (see :mod:`repro_torch.analysis.rules`) are small classes that walk a
parsed module and yield :class:`Finding`\\ s. Two suppression channels, both
explicit and both carrying a justification:

* **Inline pragma** — ``# lint: allow(rule-name)`` on the offending line,
  with a neighbouring comment saying why. For point exemptions (e.g. the
  engine's warmup sync).
* **Allowlist** — :data:`ALLOWLIST` maps ``(rule, repo-relative path)`` to a
  one-line justification. For whole-file exemptions where the rule's concern
  is the file's *job*.

Suppressed findings are still collected (``LintReport.suppressed``) so the
JSON artifact shows what is being allowed and why.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

PACKAGE = "src/repro_torch"

# ---------------------------------------------------------------------------
# allowlist: (rule, path) -> one-line justification
# ---------------------------------------------------------------------------
ALLOWLIST: Dict[Tuple[str, str], str] = {
    ("multi-sync", f"{PACKAGE}/core/budgeting.py"):
        "measure_logit_peak reads the allocator's peak on the card, an "
        "offline measurement outside the serving loop: the stream is "
        "drained before and after each mode",
    ("silent-fallback", f"{PACKAGE}/core/budgeting.py"):
        "budgeting IS the memory bill: these branches are where each "
        "logit mode is billed differently",
}

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([a-z0-9_-]+)\)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class FileContext:
    """One parsed module plus everything a rule needs to judge it."""
    path: str                      # repo-relative posix path
    source: str
    tree: ast.Module
    pragmas: Dict[int, Set[str]]   # line -> rule names allowed on that line
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


class Rule:
    """Base class: subclasses set ``name``/``description`` and yield
    findings from :meth:`check`. Registered in ``rules/__init__.py``."""
    name: str = ""
    description: str = ""

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, msg: str) -> Finding:
        return Finding(self.name, ctx.path, getattr(node, "lineno", 0), msg)


@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[dict] = field(default_factory=list)
    files_scanned: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {"ok": self.ok, "files_scanned": self.files_scanned,
                "findings": [f.to_dict() for f in self.findings],
                "suppressed": self.suppressed}


def _dotted(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` -> that string, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def build_context(path: Path, root: Path) -> FileContext:
    rel = path.relative_to(root).as_posix()
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:                      # surfaced as a finding
        ctx = FileContext(rel, source, ast.Module(body=[], type_ignores=[]),
                          {})
        ctx.syntax_error = e                      # type: ignore[attr-defined]
        return ctx
    pragmas: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _PRAGMA_RE.finditer(line):
            pragmas.setdefault(i, set()).add(m.group(1))
    parents: Dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    return FileContext(rel, source, tree, pragmas, parents)


def iter_source_files(root: Path) -> List[Path]:
    return sorted((root / PACKAGE).rglob("*.py"))


def run_lint(root: Optional[Path] = None,
             rules: Optional[List[Rule]] = None) -> LintReport:
    """Lint ``<root>/src/repro_torch`` with every registered rule."""
    from repro_torch.analysis.rules import all_rules
    if root is None:
        # src/repro_torch/analysis/lint.py -> the repo root is four up
        root = Path(__file__).resolve().parents[3]
    rules = rules if rules is not None else all_rules()
    report = LintReport()
    for path in iter_source_files(root):
        ctx = build_context(path, root)
        report.files_scanned += 1
        err = getattr(ctx, "syntax_error", None)
        if err is not None:
            report.findings.append(Finding(
                "syntax", ctx.path, err.lineno or 0, str(err)))
            continue
        for rule in rules:
            for f in rule.check(ctx):
                allowed = ctx.pragmas.get(f.line, set())
                key = (f.rule, f.path)
                if f.rule in allowed:
                    report.suppressed.append(
                        {**f.to_dict(), "via": "pragma"})
                elif key in ALLOWLIST:
                    report.suppressed.append(
                        {**f.to_dict(), "via": "allowlist",
                         "justification": ALLOWLIST[key]})
                else:
                    report.findings.append(f)
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report
