"""Synthetic serving workloads mirroring the paper's three traces (§6.1),
copied from ``repro.data.workloads`` so both packages draw the same requests
from the same seed.

  * **livebench** — medium prompts (~300 tok, lognormal), 256-token
    generations, Poisson arrivals.
  * **burst** — BurstGPT: ON/OFF bursty arrivals, heavy-tailed prompts.
  * **osc** — long prompts (~500 tok), 256-token summaries, Poisson.
  * **shared-prefix** — prompts drawn verbatim from a small prefix pool.

Lengths are scaled by ``scale`` so the same shapes exercise small and full
configs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# spawn key for every prefix-related derived stream — never the main stream
_PREFIX_STREAM = 0x70726566  # "pref"


@dataclass(frozen=True)
class TraceRequest:
    arrival: float      # seconds
    prompt_len: int
    gen_len: int
    deadline: float = float("inf")   # arrival + deadline_slack (no rng draw)
    prefix_id: int = -1              # shared-prefix pool entry (-1 = unique)
    prefix_len: int = 0


@dataclass(frozen=True)
class PrefixSpec:
    """Shape of the shared-prefix trace's prompt pool."""
    n_prefixes: int = 4
    prefix_len: int = 64
    tail_len: int = 0


def _poisson_arrivals(n: int, rps: float, rng) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rps, n))


def _burst_arrivals(n: int, rps: float, rng, burst_factor: float = 6.0,
                    p_on: float = 0.3) -> np.ndarray:
    """Markov-modulated Poisson: ON periods at burst_factor×rate."""
    out = []
    t = 0.0
    on = False
    while len(out) < n:
        on = rng.random() < (p_on if not on else 0.7)
        rate = rps * burst_factor if on else rps * 0.4
        k = min(n - len(out), rng.integers(2, 8))
        for _ in range(k):
            t += rng.exponential(1.0 / rate)
            out.append(t)
    return np.asarray(out[:n])


def make_trace(name: str, n: int, rps: float, seed: int = 0,
               scale: float = 1.0,
               deadline_slack: float = float("inf"),
               prefix: Optional[PrefixSpec] = None) -> List[TraceRequest]:
    """``deadline_slack``: seconds after arrival by which each request must
    finish (inf = none). ``prefix`` shapes the shared-prefix pool."""
    rng = np.random.default_rng(seed)
    if name == "shared-prefix":
        spec = prefix or PrefixSpec()
        arr = _poisson_arrivals(n, rps, rng)
        glen = np.full(n, 256)
        pref = max(4, int(spec.prefix_len * scale))
        tail = max(0, int(spec.tail_len * scale))
        prng = np.random.default_rng([seed, _PREFIX_STREAM])
        ids = prng.integers(0, spec.n_prefixes, n)
        return [TraceRequest(float(a), pref + tail, max(4, int(g * scale)),
                             deadline=float(a) + deadline_slack,
                             prefix_id=int(i), prefix_len=pref)
                for a, g, i in zip(arr, glen, ids)]
    if name == "livebench":
        arr = _poisson_arrivals(n, rps, rng)
        plen = np.clip(rng.lognormal(np.log(300), 0.4, n), 50, 900)
        glen = np.full(n, 256)
    elif name == "burst":
        arr = _burst_arrivals(n, rps, rng)
        plen = np.clip((rng.pareto(1.8, n) + 1) * 120, 30, 1500)
        glen = np.full(n, 256)
    elif name == "osc":
        arr = _poisson_arrivals(n, rps, rng)
        plen = np.clip(rng.normal(500, 120, n), 150, 1200)
        glen = np.full(n, 256)
    else:
        raise ValueError(name)
    return [TraceRequest(float(a), max(4, int(p * scale)),
                         max(4, int(g * scale)),
                         deadline=float(a) + deadline_slack)
            for a, p, g in zip(arr, plen, glen)]


def trace_prompts(trace: List[TraceRequest], vocab_size: int,
                  seed: int = 0) -> List[np.ndarray]:
    """Prompt token arrays for ``trace``: one main-stream draw per request;
    prefix-bearing requests then overwrite their first ``prefix_len`` tokens
    from a per-(id, len) derived stream."""
    rng = np.random.default_rng(seed + 1)
    pool: Dict[Tuple[int, int], np.ndarray] = {}
    out = []
    for t in trace:
        p = rng.integers(0, vocab_size - 1, t.prompt_len).astype(np.int32)
        if t.prefix_id >= 0 and t.prefix_len > 0:
            key = (t.prefix_id, t.prefix_len)
            if key not in pool:
                kr = np.random.default_rng(
                    [seed + 1, _PREFIX_STREAM, t.prefix_id, t.prefix_len])
                pool[key] = kr.integers(
                    0, vocab_size - 1, t.prefix_len).astype(np.int32)
            k = min(t.prefix_len, t.prompt_len)
            p[:k] = pool[key][:k]
        out.append(p)
    return out


def prefix_share_factor(trace: List[TraceRequest]) -> float:
    """Logical/physical slot ratio the trace admits under whole-slot
    content sharing: requests whose prompt is drawn VERBATIM from the pool
    (prefix covers the full prompt) and that share (prefix_id, prompt_len,
    gen_len) produce bit-identical token arrays — one physical slot backs
    the group. Everything else (unique prompts, partial prefixes) is billed
    one slot each. This is the ``share_factor`` fed to
    ``budgeting.plan_memory`` / ``baselines.size_slots``."""
    groups: Dict[Tuple[int, int, int], int] = {}
    unique = 0
    for t in trace:
        if t.prefix_id >= 0 and t.prefix_len >= t.prompt_len:
            key = (t.prefix_id, t.prompt_len, t.gen_len)
            groups[key] = groups.get(key, 0) + 1
        else:
            unique += 1
    phys = len(groups) + unique
    return len(trace) / phys if phys else 1.0


WORKLOADS = ("livebench", "burst", "osc", "shared-prefix")
