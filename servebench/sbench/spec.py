"""What a run reads from the benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and every metric. Each configuration is
``servebench/configs/<config>.json``, each mix
``servebench/traffic/<traffic>.json``, each metric a reader
``servebench/metrics/<metric>.py`` with ``read(run) -> float | None``, and
each configuration names its plain reference,
``servebench/references/<reference>.py``. A later cell, configuration, mix
or metric is a new file and a new entry: nothing here changes.

The reference is where a model family lives. Besides the replay the check
calls (``hidden_at``, ``Head``), it declares ``layout(model)``, the
``(path, shape, std)`` of every leaf in draw order, which
:mod:`sbench.weights` draws and :mod:`sbench.serve` hands to the engine
at whatever nesting the paths give, and ``token_params(model)``, the
parameters a Refresh or Reuse token multiplies, which ``step_mfu`` counts
(:mod:`sbench.flops`). So a new family is a configuration file and a
reference file, with its mixes, metrics and entries: nothing under
``sbench/`` knows a family.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]   # None: every cell

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration file, as run
    traffic: dict         # the mix file
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path

    def metrics(self, trace: bool) -> List[Metric]:
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if m.applies(self.name)]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries: List[dict]) -> List[Metric]:
    return [Metric(e["name"], e["unit"], e.get("workloads"))
            for e in entries]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / confs[w["config"]]["file"])
    traffic = _load_json(root / "servebench" / "traffic"
                         / f"{w['traffic']}.json")
    return Cell(name, config, traffic, int(w["chips"]),
                _metrics(bench["end_to_end"]), _metrics(bench["per_layer"]),
                root)


def _module(path: Path, label: str):
    """The module at ``path``, loaded once a process under ``label``."""
    if label in sys.modules:
        return sys.modules[label]
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[label]
        raise
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``servebench/metrics/<name>.py``."""
    return _module(root / "servebench" / "metrics" / f"{name}.py",
                   f"servebench_metric_{name.replace('.', '_')}").read


def reference(name: str, root: Path = ROOT):
    """The plain reference module ``servebench/references/<name>.py``."""
    return _module(root / "servebench" / "references" / f"{name}.py",
                   f"servebench_reference_{name}")


def read_metrics(cell: Cell, run, trace: bool) -> Dict[str, dict]:
    """Every metric of the cell for this kind of run, by its reader; a
    reader that finds nothing to read returns None and the metric is left
    out."""
    out = {}
    for m in cell.metrics(trace):
        value = metric_reader(m.name, cell.root)(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
