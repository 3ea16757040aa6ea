"""Helpers of the port's tests (``tests/test_torch_*.py``), which import
this module before they build anything.

* **Threads.** Under pytest-xdist every worker is a process of its own,
  and torch's intra-op pool defaults to one thread per core in each: six
  workers on eight cores would run 48 spinning threads, which starve the
  other workers' JAX compiles. The cap gives each worker its share of the
  cores, ``max(1, cores // workers)`` (1 under the tier-1 command's six
  workers on eight cores; every core in a run without xdist). JAX's
  threads are left as they are.
* **Reference serves.** A parity case runs the JAX reference's engine,
  and several cases often compare against the same serve (the port's
  pipelined and synchronous loops, its packed and padded paths, its
  stream events). :func:`cached` keeps each result for the process, keyed
  on what determines it: arch, overrides, serve config, requests, seed.
  Under ``--dist loadfile`` a file's cases share one worker, hence its
  cache.
* **Shard checks.** :func:`shard_check` runs ``python -m
  repro_torch.launch.shard_check`` on two gloo ranks of the CPU and holds
  its record to the tool's law (the mesh files share it).
* **MoE ranks.** :func:`moe_rank` runs one MoE layer on a rank of
  ``launch.mesh.spawn`` (a function of its own module, so a spawned rank
  imports it without the test file's JAX imports).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, Dict, Hashable

import numpy as np
import torch


def thread_cap() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or "1")
    return max(1, (os.cpu_count() or 1) // max(1, workers))


torch.set_num_threads(thread_cap())

_CACHE: Dict[Hashable, object] = {}


def freeze(x) -> Hashable:
    """A hashable stand-in for a key part: arrays by dtype, shape and
    bytes; dicts by sorted items; lists and tuples element by element."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return tuple(sorted((k, freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(freeze(v) for v in x)
    return x


def cached(key, compute: Callable[[], object]):
    """``compute()``, once per ``key`` in this process."""
    k = freeze(key)
    if k not in _CACHE:
        _CACHE[k] = compute()
    return _CACHE[k]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shard_check(arch: str, extra, tmp_path) -> dict:
    """One ``shard_check`` run of ``arch`` on two gloo ranks of the CPU
    (``extra``: its flags); asserts it agreed with the one-device serve on
    a mesh of two, and returns its JSON record."""
    out = tmp_path / "agree.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.shard_check", "--arch",
         arch, "--device", "cpu", "--out", str(out)] + list(extra),
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert rec["ok"], rec
    assert rec["mesh_devices"] == 2, rec
    assert rec["device"] == "cpu" and min(rec["rank_collectives"]) > 0
    if "--sharing" in extra:
        assert rec["shared_hits"] > 0, rec
    return rec


def moe_rank(mesh, cfg, stack: dict, x: np.ndarray, layer: int = 0) -> dict:
    """One rank's MoE layer on ``mesh``: ``stack`` (the ``[nl, ...]`` expert
    stacks as numpy arrays) cut to the rank's shards as the engine cuts
    them (``params.shard_cut``), then ``moe_ffn`` on ``x`` at ``layer``.
    Returns the output, the aux loss, each dispatch the call made (slot,
    keep, token of each slot), the bytes of the rank's stacks and its
    collectives."""
    from repro_torch.launch.sharding import Rules
    from repro_torch.models import moe as TM
    from repro_torch.params import shard_cut
    cut = shard_cut(Rules(cfg, mesh, train=False), mesh)
    held = {k: cut(f"stack/{k}", torch.tensor(v))
            for k, v in stack.items()}
    seen, dispatch = [], TM._dispatch_indices

    def record(*args):
        out = dispatch(*args)
        seen.append([t.numpy().copy() for t in out])
        return out
    TM._dispatch_indices = record
    try:
        out, aux = TM.moe_ffn({k: v[layer] for k, v in held.items()},
                              torch.from_numpy(x), cfg)
    finally:
        TM._dispatch_indices = dispatch
    return dict(out=out.numpy(), aux=float(aux), dispatch=seen,
                shapes={k: tuple(v.shape) for k, v in held.items()},
                bytes=sum(v.numel() * v.element_size()
                          for v in held.values()),
                collectives=mesh.collectives)
