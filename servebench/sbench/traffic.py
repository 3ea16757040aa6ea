"""Traffic: one general generator driven by a mix file.

:func:`make_trace` and its arrival processes are a frozen copy of
``repro_torch.data.workloads`` (the paper's livebench, burst and osc
traces), so the yardstick does not move when the program's copy does.

A mix file (``servebench/traffic/<name>.json``) sets:

* ``generator``: livebench | burst | osc, drawn from ``mix_seed``;
* ``scale``: the generator's length scale;
* ``arrivals``: ``backlog`` (every fresh request due at t = 0) or ``rate``
  (the generator's arrival times at ``rps`` requests a second);
* ``fresh``: how many fresh requests;
* ``residents``: in-flight residents, a count or ``"slots"`` (as many as
  the served slots). A resident stands for a request a running endpoint
  already holds: due at t = 0, it has generated ``k`` of its blocks, its
  prompt carries those ``k`` blocks of tokens and its ``gen_len`` is what
  is left. The ``k`` are spread evenly over ``0 .. n_blocks - 1``.

Generation lengths are whole blocks (the engine pads them so), and a
prompt is cut to what ``max_seq_len`` leaves beside its generation.

Every seed gets the same requests in the same order at the same times:
``mix_seed`` draws the sizes, the residents' ``k`` and the arrivals, and
``--seed`` draws the token ids (and the harness the weights). So the work
of a run does not change with the seed: which requests a 51 s window
finishes depends on their order, and an order drawn from the seed moved
``tok_s`` by up to 3% between seeds against 0.5% between two runs of one
seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


# ---- the frozen copy of repro_torch/data/workloads.py --------------------
@dataclass(frozen=True)
class TraceRequest:
    arrival: float      # seconds
    prompt_len: int
    gen_len: int
    deadline: float = float("inf")
    prefix_id: int = -1
    prefix_len: int = 0


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
               deadline_slack: float = float("inf")) -> List[TraceRequest]:
    rng = np.random.default_rng(seed)
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
# ---- end of the frozen copy ----------------------------------------------


@dataclass
class Req:
    rid: int
    prompt: np.ndarray      # int32 ids, the resident's generated blocks last
    gen_len: int            # tokens still to generate
    due: float              # seconds after the window opens
    resident: bool          # an in-flight resident (its first block is old)
    k: int                  # blocks a resident had generated before


def build(mix: dict, seed: int, *, slots: int, vocab_size: int,
          block_size: int, max_seq_len: int) -> List[Req]:
    """The run's requests, residents first (rid order = submit order)."""
    scale = float(mix.get("scale", 1.0))
    gen = mix["generator"]
    n_res = slots if mix["residents"] == "slots" else int(mix["residents"])
    n_fresh = int(mix["fresh"])
    rps = float(mix.get("rps") or 1.0)
    base = int(mix["mix_seed"])
    fresh = make_trace(gen, n_fresh, rps, seed=base, scale=scale)
    res = make_trace(gen, n_res, rps, seed=base + 1, scale=scale)
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0x5e])
    mask = vocab_size - 1

    def ids(n: int) -> np.ndarray:
        # token ids below the mask id
        return rng.integers(0, mask, n).astype(np.int32)

    out: List[Req] = []
    whole = lambda g: -(-g // block_size) * block_size  # noqa: E731
    gl = whole(res[0].gen_len if res else fresh[0].gen_len)
    n_blocks = gl // block_size
    # the mix fixes each resident's k with its size, and the order
    ks = np.random.default_rng(base + 2).permutation(
        (np.arange(n_res) * n_blocks) // max(1, n_res))
    for rid, (t, k) in enumerate(zip(res, ks)):
        g = whole(t.gen_len) - int(k) * block_size
        p = min(t.prompt_len, max_seq_len - whole(t.gen_len))
        out.append(Req(rid, np.concatenate([ids(p), ids(int(k) * block_size)]),
                       g, 0.0, True, int(k)))
    for j, t in enumerate(fresh):
        due = 0.0 if mix["arrivals"] == "backlog" else t.arrival
        p = min(t.prompt_len, max_seq_len - whole(t.gen_len))
        out.append(Req(n_res + j, ids(p), whole(t.gen_len), due, False, 0))
    return out
