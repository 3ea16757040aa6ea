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
"""
from __future__ import annotations

import os
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
