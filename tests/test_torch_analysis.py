"""The port's analyzer: the lint, the grid audit, the retrace sentinel, and
the ``sparse_kv`` names.

* Each lint rule fires exactly once on a snippet with one violation of
  it; the pragma suppresses; a raising or billed dispatch and a single
  annotated sync are clean; ``src/repro_torch`` lints clean.
* ``run_grid_audit`` gives every (arch, mesh) cell of the 11 archs × 4
  mesh shapes the reference's status (ok / expected-raise), and each
  stage's output leaf shapes equal the reference's ``eval_shape``
  shapes, path for path.
* ``check_engine`` flags an unwarmed engine and passes a warmed one.
* ``repro_torch.core.sparse_kv`` exports the reference's six names, each
  the port module's own object.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import numpy as np
import pytest

from repro.analysis.trace_audit import run_grid_audit as jrun_grid_audit
from repro_torch.analysis.lint import ALLOWLIST, run_lint
from repro_torch.analysis.retrace import check_engine
from repro_torch.analysis.rules import all_rules
from repro_torch.analysis.trace_audit import MESH_SHAPES, run_grid_audit
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import ServeConfig
from repro_torch.core.engine import Engine
from repro_torch.launch import mesh as M

# each source holds EXACTLY ONE violation of its rule
VIOLATIONS = {
    "mesh-api": "import torch.distributed as dist\n",
    "graph-capture": ("import torch\n"
                      "g = torch.cuda.CUDAGraph()\n"),
    "host-sync": "def f(x):\n    return x.item()\n",
    "silent-fallback": ("def dispatch(serve, x):\n"
                        "    if serve.use_flash_kernel:\n"
                        "        x = x + 1\n"
                        "    return x\n"),
    # two annotated syncs: each line passes host-sync via its pragma, but
    # the function still stalls twice: multi-sync fires on the second
    "multi-sync": ("def f(a, b):\n"
                   "    x = a.tolist()  # lint: allow(host-sync)\n"
                   "    y = b.cpu()  # lint: allow(host-sync)\n"
                   "    return x, y\n"),
}


def _lint_fixture(tmp_path, name, source):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / f"fixture_{name.replace('-', '_')}.py").write_text(source)
    return run_lint(root=tmp_path, rules=all_rules())


@pytest.mark.parametrize("rule", sorted(VIOLATIONS))
def test_rule_fires_exactly_once(tmp_path, rule):
    report = _lint_fixture(tmp_path, rule, VIOLATIONS[rule])
    assert [f.rule for f in report.findings] == [rule], report.findings


def test_rules_cover_the_reference_but_donation():
    names = {r.name for r in all_rules()}
    assert names == {"mesh-api", "graph-capture", "host-sync",
                     "multi-sync", "silent-fallback"}
    import repro_torch.analysis as A
    assert "donation" in A.__doc__ and "no buffer donation" in A.__doc__


def test_home_modules_are_exempt(tmp_path):
    """``torch.distributed`` in the mesh module and a capture in
    ``core/graphs.py`` are their jobs."""
    for rel, src in (("launch/mesh.py", VIOLATIONS["mesh-api"]),
                     ("core/graphs.py", VIOLATIONS["graph-capture"])):
        path = tmp_path / "src" / "repro_torch" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    assert run_lint(root=tmp_path).ok


def test_pragma_suppresses(tmp_path):
    src = "def f(x):\n    return x.numpy()  # lint: allow(host-sync)\n"
    report = _lint_fixture(tmp_path, "pragma", src)
    assert report.ok
    assert [s["rule"] for s in report.suppressed] == ["host-sync"]
    assert report.suppressed[0]["via"] == "pragma"


def test_accounted_dispatch_is_clean(tmp_path):
    src = ("def dispatch(serve, x):\n"
           "    if serve.use_flash_kernel:\n"
           "        require_divisible('k', 'n_heads')\n"
           "        x = x + 1\n"
           "    if serve.kv_quant == 'int8':\n"
           "        raise ValueError('x')\n"
           "    return x\n")
    report = _lint_fixture(tmp_path, "accounted", src)
    assert report.ok, report.findings


def test_single_annotated_sync_is_clean(tmp_path):
    src = ("def f(a, b):\n"
           "    x = a.tolist()  # lint: allow(host-sync)\n"
           "    return x, b\n")
    report = _lint_fixture(tmp_path, "one-sync", src)
    assert report.ok, report.findings


def test_repo_lints_clean():
    """The port passes its own gate (``python -m repro_torch.analysis
    --strict``); every allowlisted file exists and every pragma names a
    rule."""
    report = run_lint()
    assert report.ok, "\n".join(str(f) for f in report.findings)
    assert report.files_scanned > 70
    assert {s["via"] for s in report.suppressed} == {"pragma", "allowlist"}
    rules = {r.name for r in all_rules()}
    assert {s["rule"] for s in report.suppressed} <= rules
    assert {rule for rule, _ in ALLOWLIST} <= rules


# ---------------------------------------------------------------------------
# grid audit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def audits():
    return (jrun_grid_audit(archs=sorted(ARCHS)),
            run_grid_audit(archs=sorted(ARCHS)))


def test_grid_audit_classifies_as_the_reference(audits):
    want, got = audits
    assert got.ok, [c.to_dict() for c in got.errors]
    key = lambda c: (c.arch, tuple(c.mesh))     # noqa: E731
    w = {key(c): (c.status, c.plan) for c in want.cells}
    g = {key(c): (c.status, c.plan) for c in got.cells}
    assert len(g) == len(ARCHS) * len(MESH_SHAPES)
    assert g == w
    # gemma-2b's one KV head cannot split over a 2-way model axis
    assert g[("gemma-2b", (1, 2))][0] == "expected-raise"
    assert g[("llada-8b", (2, 2))] == ("ok", {"n_heads": 2,
                                              "n_kv_heads": 2,
                                              "vocab_size": 2})


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stage_shapes_equal_the_reference(audits, arch):
    want, got = audits
    assert set(got.stage_shapes[arch]) == {
        "refresh", "refresh_packed", "reuse", "reuse_packed", "decode",
        "decode_packed"}
    assert got.stage_shapes[arch] == want.stage_shapes[arch]


def test_grid_audit_leaves_no_mesh_active():
    assert M.active() is None
    run_grid_audit(archs=["llada-8b"], trace_stages=False)
    assert M.active() is None


# ---------------------------------------------------------------------------
# retrace sentinel
# ---------------------------------------------------------------------------

def _engine():
    cfg = reduced(get_config("llada-8b"))
    serve = ServeConfig(max_seq_len=64, block_size=8, steps_per_block=4,
                        max_slots=2, max_num_batched_tokens=256,
                        max_num_logits=64, varlen_pack=True,
                        logit_mode="chunked", use_flash_kernel=False)
    eng = Engine(cfg, serve, clock="modeled", device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        eng.submit(rng.integers(0, cfg.vocab_size - 1, 12), gen_len=8,
                   arrival=0.0, rid=i)
    return eng


def test_check_engine_flags_an_unwarmed_engine():
    eng = _engine()
    eng.run()
    report = check_engine(eng)
    assert not report.ok
    assert any("warmup" in v for v in report.violations)
    assert report.compiles_post_warmup > 0


def test_check_engine_passes_a_warmed_engine():
    eng = _engine()
    eng.warmup()
    eng.run()
    report = check_engine(eng)
    assert report.ok, report.violations
    assert report.compiles_warmup > 0 and report.compiles_post_warmup == 0
    assert report.to_dict()["ok"]


# ---------------------------------------------------------------------------
# sparse_kv
# ---------------------------------------------------------------------------

def test_sparse_kv_reexports_the_port_objects():
    import repro.core.sparse_kv as J
    from repro_torch.core import kv_pool, sparse_kv
    from repro_torch.models import sparse_select
    names = ("KVPool", "PackedKV", "head_scores", "pack", "select_and_pack",
             "select_indices")
    for n in names:
        assert hasattr(J, n), n
    assert sparse_kv.KVPool is kv_pool.KVPool
    for n in names[1:]:
        assert getattr(sparse_kv, n) is getattr(sparse_select, n), n
