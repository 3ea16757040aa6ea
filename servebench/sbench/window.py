"""The window's arithmetic, from the stamped events alone.

What an event committed is read from the block it carries: the positions
that its block held masked before it and shows unmasked now, never the
program's own count. The schedule is the configuration's (linear
unmasking: each step commits ``ceil(masked / steps left)``, the last all
that is left); :func:`commits` sets each event's count beside it.

A block is complete when the event that lands it leaves no mask id in it.
Its latency is the time since the request's previous block reached the
host, or, for a request's first block, since the request was due. An
in-flight resident's first block in the window began before the window,
so it is left out. A request due in the window that never completes its
first block counts at the window's end less its due time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np


def commit_count(n_masked: int, steps_left: int) -> int:
    """The linear unmasking schedule: finish the block by its last step."""
    if steps_left <= 1:
        return n_masked
    return max(1, -(-n_masked // steps_left))


@dataclass
class Commit:
    step: int       # the step's index in its block
    masked: list    # positions of the block masked before the step
    new: list       # of those, the positions the event shows unmasked
    due: int        # the schedule's count for the step
    changed: int    # positions committed before whose id the event changed


def commits(events, reqs, block_size: int, steps_per_block: int,
            mask_id: int) -> List[Commit]:
    """One :class:`Commit` an event, in order. A block's first event sees
    its generated positions masked (``gen_len`` says how many of a last
    block's are)."""
    gen = {r.rid: r.gen_len for r in reqs}
    state: Dict[tuple, tuple] = {}
    out = []
    for e in events:
        key = (e.rid, e.block_idx)
        if key not in state:
            n = min(block_size, max(0, gen[e.rid] - e.block_idx * block_size))
            was = np.zeros(block_size, bool)
            was[:n] = True
            state[key] = (0, was, None)
        step, was, ids = state[key]
        post = np.asarray(e.tokens)
        now = post == mask_id
        new = np.nonzero(was & ~now)[0]
        changed = 0 if ids is None else int(((~was) & (post != ids)).sum())
        out.append(Commit(step, np.nonzero(was)[0].tolist(), new.tolist(),
                          commit_count(int(was.sum()),
                                       steps_per_block - step), changed))
        state[key] = (step + 1, was & now, post.copy())
    return out


def schedule_misses(cs: Sequence[Commit]) -> int:
    """Events that commit other than the schedule's count or change a
    committed token."""
    return sum(1 for c in cs if len(c.new) != c.due or c.changed)


def committed_tokens(events, cs: Sequence[Commit], seconds: float) -> int:
    return sum(len(c.new) for e, c in zip(events, cs) if e.t < seconds)


def tok_s(run) -> float:
    """Committed tokens whose ids reached the host inside the window, over
    its length."""
    s = run.config["serve"]
    cs = commits(run.events, run.reqs, s["block_size"], s["steps_per_block"],
                 run.mask_id)
    return committed_tokens(run.events, cs, run.seconds) / run.seconds


def completions(events, mask_id: int, seconds: float) -> Dict[int, List[float]]:
    """rid -> host times of its completed blocks inside the window."""
    out: Dict[int, List[float]] = {}
    for e in events:
        if e.t < seconds and not (np.asarray(e.tokens) == mask_id).any():
            out.setdefault(e.rid, []).append(e.t)
    return out


def block_latencies(events, reqs, mask_id: int, seconds: float) -> List[float]:
    done = completions(events, mask_id, seconds)
    out: List[float] = []
    for r in reqs:
        ts = done.get(r.rid, [])
        if not r.resident:
            if r.due >= seconds:
                continue
            if not ts:
                out.append(seconds - r.due)
                continue
            out.append(ts[0] - r.due)
        out.extend(b - a for a, b in zip(ts, ts[1:]))
    return out


def first_block_latencies(events, reqs, mask_id: int,
                          seconds: float) -> List[float]:
    """Due to first block, for fresh requests due in the window."""
    done = completions(events, mask_id, seconds)
    return [(done[r.rid][0] if r.rid in done else seconds) - r.due
            for r in reqs if not r.resident and r.due < seconds]


def percentile(values: Sequence[float], q: float):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else None


def window_rows(rows, seconds: float) -> list:
    """The engine's ``iter_log`` rows planned inside the window."""
    return [r for r in rows if r["t"] < seconds]
