"""How ``correct`` is decided: the program's served tokens, the positions
it committed and how many, against the configuration's schedule and the
plain reference's logits.

Every event of the window is held to the schedule (``window.commits``):
each step commits the linear schedule's count of positions, and no event
changes a committed token. ``schedule_misses`` counts the events that do
otherwise; its limit is 0.

Once the window has closed and the program's device state is freed, a
sample drawn from the seed of the requests that finished (the one with the
most served tokens first, then others in a seeded order until the sample
holds ``sample_tokens`` served tokens or ``sample_requests`` requests) is
replayed by the configuration's reference, step by step, from the
sequences the program served: each step's state before it, whether it was
a Refresh or a Reuse (a function of the step's index in its block), and
every position still masked before it. Two numbers come of it:

* ``logit_gap``: at each committed position, the reference's best logit
  less its logit of the token served; the widest. The ids are greedy, so
  a sound program's gaps are rounding; a token altered where it is
  produced, a stage that skips its work or a lost row widens them.
* ``order_regret``: the engine commits the masked positions it is most
  confident of (confidence: the softmax's largest probability). At each
  step that leaves a position masked, the reference's highest
  log-confidence among the positions left masked less its lowest among
  those committed, 0 if none is higher; the mean over those steps. A
  sound program's is rounding among near ties; one that commits other
  positions than its most confident raises it on every step. The mean,
  not the widest: the widest is one near tie, the same for a sound
  program and one that commits the least confident positions.

The control puts the reference in the program's place at the next
precision below the configuration's (:data:`LOWER`): at each replayed step
it commits the schedule's count of positions it is most confident of, with
its own first token, and is judged by the same numbers and
:func:`decide`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

# the nearest precision below a configuration's: its control
LOWER = {"bfloat16": "float8_e4m3fn", "float32": "bfloat16"}
# numbers compared as ``value >= limit``; every other as ``value <= limit``
AT_LEAST = ("judged_tokens",)
CHUNK = 1024    # logit rows at a time


@dataclass
class Judged:
    """The sample's replayed steps and, a row each (every position masked
    before a step, in the reference's row order), what the program did."""
    steps: list          # per request: the reference's Steps
    step: np.ndarray     # [rows] the row's step, counted over the sample
    committed: np.ndarray  # [rows] bool: the program committed it there
    served: np.ndarray   # [rows] the id served (0 where not committed)
    due: np.ndarray      # [steps] the schedule's count of each step
    rids: List[int]


def _by_rid(events) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for e in events:
        out.setdefault(e.rid, []).append(e)
    return out


def finished(reqs, events, mask_id: int, block_size: int) -> List:
    """The requests whose every block landed inside the window."""
    evs = _by_rid(events)
    out = []
    for r in reqs:
        n_blocks = -(-r.gen_len // block_size)
        done = sum(1 for e in evs.get(r.rid, ())
                   if not (np.asarray(e.tokens) == mask_id).any())
        if done == n_blocks:
            out.append(r)
    return out


def sample(done: List, seed: int, tokens: int, requests: int) -> List:
    if not done:
        return []
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0xc4ec])
    longest = max(r.gen_len for r in done)
    top = [r for r in done if r.gen_len == longest]
    first = top[int(rng.integers(len(top)))]
    rest = [done[i] for i in rng.permutation(len(done)) if done[i] is not first]
    out, n = [first], first.gen_len
    for r in rest:
        if n >= tokens or len(out) >= requests:
            break
        out.append(r)
        n += r.gen_len
    return out


def steps_of(req, events, cs, ref_mod, geom: dict, mask_id: int):
    """The reference's Steps of one served request, rebuilt from its
    stream events in order (``cs`` their ``window.Commit``), and per
    row whether it was committed and the id served there."""
    Sb, ri = geom["block_size"], geom["refresh_interval"]
    P = len(req.prompt)
    seq = np.concatenate([req.prompt.astype(np.int64),
                          np.full(req.gen_len, mask_id, np.int64)])
    toks, starts, refresh, cache_of, rows = [], [], [], [], []
    step_of, committed, served, due = [], [], [], []
    last_refresh = -1
    for i, (e, c) in enumerate(zip(events, cs)):
        s = P + e.block_idx * Sb
        is_refresh = c.step == 0 or (ri and c.step % ri == 0)
        if is_refresh:
            last_refresh = i
        post = np.asarray(e.tokens, dtype=np.int64)
        new = set(c.new)
        toks.append(seq.copy())
        starts.append(s)
        refresh.append(is_refresh)
        cache_of.append(last_refresh)
        for p in c.masked:
            rows.append((i, s + p))
            step_of.append(i)
            committed.append(p in new)
            served.append(int(post[p]) if p in new else 0)
        due.append(c.due)
        seq[s: s + Sb] = post
    st = ref_mod.Steps(tokens=np.stack(toks), block_start=np.asarray(starts),
                       refresh=np.asarray(refresh, bool),
                       cache_of=np.asarray(cache_of), rows=rows)
    return st, step_of, committed, served, due


def judge(picked, events, cs, ref_mod, geom: dict, mask_id: int) -> Judged:
    """The sample's steps; ``cs`` the window's commits, one an event."""
    evs: Dict[int, list] = {}
    for e, c in zip(events, cs):
        evs.setdefault(e.rid, []).append((e, c))
    steps, step, committed, served, due = [], [], [], [], []
    for r in picked:
        es, rcs = zip(*evs[r.rid])
        st, s_of, com, ids, d = steps_of(r, es, rcs, ref_mod, geom, mask_id)
        steps.append(st)
        step += [len(due) + i for i in s_of]
        committed += com
        served += ids
        due += d
    return Judged(steps, np.asarray(step, np.int64),
                  np.asarray(committed, bool), np.asarray(served, np.int64),
                  np.asarray(due, np.int64), [r.rid for r in picked])


def _at(logits: torch.Tensor, ids: torch.Tensor, mask_id: int):
    """The logit of each row's id. A 0 may stand for a predicted mask id
    (the engine commits 0 in its place), so it is read as the better of
    the two."""
    got = logits.gather(1, ids[:, None])[:, 0]
    return torch.where(ids == 0, torch.maximum(got, logits[:, mask_id]), got)


def _log_conf(logits: torch.Tensor) -> torch.Tensor:
    return logits.max(dim=1).values - torch.logsumexp(logits, dim=1)


def step_gaps(lc: np.ndarray, step: np.ndarray, committed: np.ndarray,
              n_steps: int) -> np.ndarray:
    """[steps] the highest ``lc`` among a step's rows left masked less the
    lowest among those committed, 0 where none is higher; NaN where the
    step left nothing masked."""
    hi = np.full(n_steps, -np.inf)
    lo = np.full(n_steps, np.inf)
    np.maximum.at(hi, step[~committed], lc[~committed])
    np.minimum.at(lo, step[committed], lc[committed])
    with np.errstate(invalid="ignore"):
        gap = np.maximum(hi - lo, 0.0)
    gap[hi == -np.inf] = np.nan
    return gap


def order(lc, step, committed, n_steps) -> dict:
    """Over the steps that leave a position masked: the mean of
    :func:`step_gaps` (``order_regret``, compared), and, read beside it,
    the widest and the share of steps above 0."""
    g = step_gaps(lc, step, committed, n_steps)
    g = g[~np.isnan(g)]
    return {"regret": float(g.mean()) if len(g) else 0.0,
            "widest": float(g.max(initial=0.0)),
            "share": float((g > 0).mean()) if len(g) else 0.0}


def top_by_step(lc: np.ndarray, step: np.ndarray, due: np.ndarray
                ) -> np.ndarray:
    """[rows] bool: each step's ``due[step]`` rows of highest ``lc``."""
    pick = np.zeros(len(lc), bool)
    order = np.lexsort((-lc, step))
    keys = step[order]
    starts = np.searchsorted(keys, np.arange(len(due)))
    ends = np.searchsorted(keys, np.arange(len(due)), side="right")
    for a, b, n in zip(starts, ends, due):
        pick[order[a: min(a + n, b)]] = True
    return pick


def readings(ref_mod, W, model: dict, geom: dict, j: Judged, mask_id: int,
             control: bool = False) -> dict:
    """The numbers the reference reads off the sample: the program's
    ``logit_gap`` and ``order`` (:func:`order`), and with ``control`` the
    control's, under ``control_``."""
    rows = len(j.step)
    out = {"logit_gap": 0.0, "order": order(np.zeros(0), np.zeros(0, int),
                                            np.zeros(0, bool), 0)}
    if not rows:
        return out
    h = ref_mod.hidden_at(W, model, geom, j.steps)
    dev = h.device
    head = ref_mod.Head(W)
    served = torch.as_tensor(j.served, device=dev)
    lc = torch.empty(rows, device=dev)
    gap = torch.zeros(rows, device=dev)
    if control:
        prec = LOWER[model["dtype"]]
        h_low = ref_mod.hidden_at(W, model, geom, j.steps, precision=prec)
        head_low = ref_mod.Head(W, prec)
        lc_low = torch.empty(rows, device=dev)
        gap_low = torch.empty(rows, device=dev)
    for a in range(0, rows, CHUNK):
        z = head(h[a: a + CHUNK])
        best = z.max(dim=1).values
        lc[a: a + CHUNK] = best - torch.logsumexp(z, dim=1)
        gap[a: a + CHUNK] = best - _at(z, served[a: a + CHUNK], mask_id)
        if control:
            zl = head_low(h_low[a: a + CHUNK])
            lc_low[a: a + CHUNK] = _log_conf(zl)
            ids = zl.argmax(dim=1)
            ids = torch.where(ids == mask_id, torch.zeros_like(ids), ids)
            gap_low[a: a + CHUNK] = best - _at(z, ids, mask_id)
            del zl
        del z
    lc_np = lc.cpu().numpy().astype(np.float64)
    out["logit_gap"] = float(gap.cpu().numpy()[j.committed].max(initial=0.0))
    out["order"] = order(lc_np, j.step, j.committed, len(j.due))
    if control:
        pick = top_by_step(lc_low.cpu().numpy().astype(np.float64), j.step,
                           j.due)
        out["control_logit_gap"] = float(
            gap_low.cpu().numpy()[pick].max(initial=0.0))
        out["control_order"] = order(lc_np, j.step, pick, len(j.due))
    return out


def decide(checks: dict) -> bool:
    """Every number within its limit."""
    return all(v >= lim if name in AT_LEAST else v <= lim
               for name, (v, lim) in checks.items())


def geometry(config: dict) -> dict:
    s = config["serve"]
    return dict(block_size=s["block_size"],
                steps_per_block=s["steps_per_block"],
                refresh_interval=s["refresh_interval"],
                retain=min(max(s["block_size"],
                               int(s["max_seq_len"] * s["retention_ratio"])),
                           s["max_seq_len"] - s["block_size"]),
                kernel_size=s["kernel_size"])
