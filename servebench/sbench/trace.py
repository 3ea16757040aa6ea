"""The traced run: ``torch.profiler`` over the window, and what the
per-layer readers take from it.

The harness labels the engine's host phases from its own side (a
``record_function`` range around each call of the engine's plan, dispatch
and sync of an iteration, and one around the whole window), so an idle gap
on the device can be told by what the host was doing. Device intervals are
the profiler's kernels, copies and sets (CUDA activity, CUPTI).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "servebench.window"
PHASES = (("_begin_iteration", "host.plan"),
          ("_dispatch_iteration", "host.dispatch"),
          ("_sync_iteration", "host.sync"))


def label_phases(eng) -> None:
    """Wrap the engine's per-iteration calls in named host ranges."""
    for attr, label in PHASES:
        fn = getattr(eng, attr)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)
        setattr(eng, attr, wrapped)


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class TraceData:
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    window: Optional[Tuple[int, int]] = None      # ns, on the trace's clock

    def calls(self, *names: str) -> List[Tuple[str, int, int]]:
        return [e for e in self.device if any(n in e[0] for n in names)]


def _span(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = int(e.start_ns())
        d = int(e.duration_ns())
    else:
        s = int(e.start_us() * 1000)
        d = int(e.duration_us() * 1000)
    return s, s + d


def collect(prof, seconds: float) -> TraceData:
    """Device intervals, the harness's host ranges, and the window
    ``[start of the window range, + seconds)``, from a stopped profiler."""
    cuda = torch.autograd.DeviceType.CUDA
    labels = {WINDOW} | {label for _, label in PHASES}
    out = TraceData()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in labels:
            # a host range is mirrored on the device's timeline as an
            # annotation: it is no device work
            if e.device_type() == cuda:
                continue
            s, t = _span(e)
            if name == WINDOW:
                out.window = (s, s + int(seconds * 1e9))
            else:
                out.host.append((name, s, t))
        elif e.device_type() == cuda:
            out.device.append((name,) + _span(e))
    out.device.sort(key=lambda x: x[1])
    out.host.sort(key=lambda x: x[1])
    return out


def busy_intervals(tr: TraceData) -> List[Tuple[int, int]]:
    """The union of device intervals, clipped to the window."""
    w0, w1 = tr.window
    merged: List[List[int]] = []
    for _, s, t in tr.device:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_s(tr: TraceData) -> float:
    return sum(t - s for s, t in busy_intervals(tr)) / 1e9


def idle_gaps(tr: TraceData) -> List[Tuple[int, int]]:
    w0, w1 = tr.window
    gaps, cur = [], w0
    for s, t in busy_intervals(tr):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def _host_label(tr: TraceData, starts: List[int], t: int) -> str:
    """The harness's host range around ``t`` (the ranges do not overlap;
    ``starts`` are theirs, ascending)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and tr.host[i][2] > t:
        return tr.host[i][0]
    return "host.loop"


def breakdown(tr: TraceData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the window, and the
    idle time by what the host was doing at each gap's midpoint."""
    w0, w1 = tr.window
    ops: Dict[str, float] = defaultdict(float)
    for name, s, t in tr.device:
        d = min(t, w1) - max(s, w0)
        if d > 0:
            ops[name[:160]] += d / 1e9
    gaps: Dict[str, float] = defaultdict(float)
    starts = [h[1] for h in tr.host]
    for s, t in idle_gaps(tr):
        gaps[_host_label(tr, starts, (s + t) // 2)] += (t - s) / 1e9
    rank = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
