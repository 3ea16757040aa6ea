"""The system under test: ``repro_torch``'s engine, built the way
``repro_torch.launch.serve`` builds it, and one measured window of it.

Set-up takes the configuration's ``dllm-serve`` profile with the kernels
on (``use_flash_kernel``, ``logit_mode="fused"``), the pipelined loop, the
wall clock and the captured stage graphs; the offline profiler
(``profile_slots``) sizes the slots at the card's memory under the
configuration's cap, and ``fit_to_budget`` builds, warms (every stage
entry captured) and bills the engine, on the benchmark's weights: the
drawn tree as the configuration's reference lays it out, each group of it
a ``Group``, so any family's nesting builds.

The window: every request is submitted with its due time and
``Engine.run`` is called once (an open loop on the run's wall clock). The
engine's ``stream_cb`` fires once a request an iteration, when the
committed ids reach the host; :class:`Stamps` stamps each event on the
host clock and ends the run at the first event past the window by raising
:class:`WindowClosed` out of the callback.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch


class WindowClosed(Exception):
    """Raised from the stream callback at the first sync past the window."""


@dataclass
class Event:
    t: float            # seconds after the window opened, host clock
    rid: int
    block_idx: int
    tokens: np.ndarray  # the block after the commit


class Stamps:
    """The engine's ``stream_cb``: each event stamped when its ids are on
    the host; the first one at or past ``seconds`` ends the run. With
    ``running`` set, each event also samples it: ``(t, running())``."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.seconds = 0.0
        self.events: List[Event] = []
        self.running: Optional[Callable[[], int]] = None
        self.samples: List[tuple] = []

    def open(self, seconds: float) -> None:
        self.events = []
        self.samples = []
        self.seconds = seconds
        self.t0 = time.perf_counter()

    def __call__(self, ev: dict) -> None:
        t = time.perf_counter() - self.t0
        if t >= self.seconds:
            raise WindowClosed
        self.events.append(Event(t, ev["rid"], ev["block_idx"],
                                 ev["tokens"]))
        if self.running is not None:
            self.samples.append((t, self.running()))


def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in config["model"].items() if k in fields}
    return ModelConfig(name=config["name"], **kw)


def serve_config(config: dict):
    """The configuration's ``ServeConfig`` under its system's profile,
    kernels on, capped at ``max_slots`` (before the profiler sizes it)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.baselines import system_profiles
    s = config["serve"]
    fields = {f.name for f in dataclasses.fields(ServeConfig)}
    base = ServeConfig(clock="wall", pipeline=True,
                       **{k: v for k, v in s.items() if k in fields})
    serve = dataclasses.replace(system_profiles(base)[s["system"]],
                                use_flash_kernel=True, logit_mode="fused")
    # the reference replays the configuration's geometry: a profile that
    # runs another is refused, not judged
    for k, v in s.items():
        if k in fields and getattr(serve, k) != v:
            raise ValueError(
                f"the {s['system']} profile serves {k}={getattr(serve, k)!r} "
                f"where the configuration states {v!r}")
    return serve


def card_gib(config: dict, device: torch.device) -> int:
    """The memory the profiler plans for: the card's (``total_memory >>
    30``, as ``launch/profile.py`` takes it), or off the card the
    configuration's assumed card."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory >> 30
    return int(config["assumed"]["card_memory_gib"])


@dataclass
class Built:
    engine: object
    slots: int
    resized_from: Optional[int]
    warmup_s: List[float]


def build(config: dict, params: dict, device: torch.device, seed: int,
          stamps: Stamps) -> Built:
    from repro_torch.core.engine import Engine
    from repro_torch.launch.serve import fit_to_budget, profile_slots
    from repro_torch.params import Group
    cfg = model_config(config)
    serve = serve_config(config)
    gib = card_gib(config, device)
    plan, serve = profile_slots(cfg, serve, serve.max_slots, gib)

    def groups(node: dict) -> Group:
        # each dict of the drawn tree a Group, at whatever depth the
        # layout declares
        return Group({n: groups(v) if isinstance(v, dict) else v
                      for n, v in node.items()})
    tree = groups(params)

    def make(serve, _params=None):
        eng = Engine(cfg, serve, params=tree, seed=seed, clock="wall",
                     stream_cb=stamps, device=device,
                     graphs=device.type == "cuda")
        return eng, eng.warmup()

    eng, _, resized_from, warmups = fit_to_budget(make, serve, plan, cfg,
                                                  gib << 30)
    return Built(eng, eng.serve.max_slots, resized_from, warmups)


def submit(eng, reqs) -> list:
    return [eng.submit(r.prompt, gen_len=r.gen_len, arrival=r.due,
                       rid=r.rid) for r in reqs]


def run_window(eng, stamps: Stamps, seconds: float) -> None:
    """One open-loop window, until the first sync past it (or the last
    request's)."""
    stamps.open(seconds)
    try:
        eng.run(time_scale=1.0)
    except WindowClosed:
        pass
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def reset(eng) -> None:
    """Return an engine whose window was cut to an empty queue and free
    slots, so a helper can serve another seed's traffic on it."""
    sched = eng.scheduler
    for r in list(sched.running):
        sched.finish(r)
    sched.waiting.clear()
    eng.stats.iter_log.clear()


def release(built: Built) -> None:
    """Free the program's device state (the slot pool, the graphs)."""
    dev = built.engine.device
    built.engine = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
