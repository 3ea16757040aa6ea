"""What the harness runs loads no JAX and not the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), the reference
loads nothing of the program, and without a card or outside a checkout a
run prints no result."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SB = ROOT / "servebench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for f in SB.rglob("*.py"):
        assert not imported_tops(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in (SB / "references").glob("*.py"):
        assert not imported_tops(f) & (FORBIDDEN | {"repro_torch", "sbench"})


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json, time, tempfile, pathlib\n"
        f"sys.path[:0] = [{str(SB)!r}, {str(ROOT / 'src')!r}]\n"
        "import sb_testing as T\n"
        "from sbench import execute\n"
        "out = T.run_tiny(T.make_root(pathlib.Path(sys.argv[1])), trace=True)\n"
        "print(json.dumps([out['correct'], execute.forbidden_modules(),\n"
        "  sorted({m.split('.')[0] for m in sys.modules})]))\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, bad, tops = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and bad == []
    assert "repro_torch" in tops and not FORBIDDEN & set(tops)


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "servebench/run.py", "--workload",
         "llada8b.livebench.sat", "--seed", str(2 ** 31 + 1), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_without_the_program_a_run_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(SB, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
