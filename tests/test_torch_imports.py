"""Import guard: the port needs neither jax nor the JAX package.

A subprocess with ``sys.modules["jax"] = None`` (any ``import jax`` raises)
imports every module of ``repro_torch``; an AST scan of the port's sources
and of ``chip_smoke.py`` (the script that drives the port on the card)
finds no import of ``jax`` or ``repro`` / ``repro.*`` (``repro_torch`` is
the port's own name and allowed)."""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 37


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_never_import_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 1
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m == "repro" or m.startswith("repro.") or m == "jax"
           or m.startswith("jax.")]
    assert bad == []
