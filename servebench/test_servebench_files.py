"""The benchmark's files: BENCHMARK.json keeps the contract's shape, and a
cell, configuration, mix or metric is found by name, so a later one is a
new file and a new entry."""
import json
import re
from pathlib import Path

import pytest

import sb_testing as T
from sbench import spec

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contracts_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["servebench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("servebench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert c["reduced"] == cfg["reduced"]
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (ROOT / "servebench" / "traffic"
                / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert (ROOT / "servebench" / "metrics" / f"{m['name']}.py").exists()
        moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        for cell in m.get("workloads", names):
            assert cell in moved.get("workloads", names)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = spec.load_cell(cell, ROOT)
    assert c.config["model"]["dtype"] == "bfloat16"
    assert c.metrics(trace=False) and c.metrics(trace=True)
    assert "setup_s" in {m.name for m in c.metrics(trace=False)}
    spec.reference(c.config["reference"], ROOT)
    for m in c.metrics(False) + c.metrics(True):
        assert callable(spec.metric_reader(m.name, ROOT))


def test_a_dropped_in_metric_is_read_by_name(tmp_path):
    root = T.make_root(
        tmp_path, extra_metrics={"events_seen": (
            "def read(run):\n    return len(run.events)\n")},
        per_layer=[{"name": "events_seen", "unit": "events",
                    "better": "higher", "source": "host_clock",
                    "layer": "engine loop", "moves": "tok_s"}])
    cell = spec.load_cell("tiny.cell", root)
    assert cell.config["name"] == "tiny"
    assert cell.traffic["generator"] == "livebench"
    out = T.run_tiny(root, trace=True)
    assert out["metrics"]["events_seen"]["value"] > 0
    assert out["correct"]


def test_an_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="llada8b"):
        spec.load_cell("no.such.cell", ROOT)
