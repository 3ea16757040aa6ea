"""The system under test set up once, and its measured windows.

A benchmark run is one :class:`Session` with one window
(:func:`sbench.execute.execute`); the helpers that read a limit over a
dozen seeds or sweep a rate (``control.py``, ``sweep.py``) open more
windows on the same set-up. Before each later window the weights are
redrawn in place from its seed (the captured graphs read the same
tensors) and the engine is returned to an empty queue; the program's
device state is freed (:meth:`Session.close`) before any reference runs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from sbench import flops, serve, spec, trace as tracing, traffic, weights


@dataclass
class Run:
    """What a metric reader and the check read."""
    cell: str
    config: dict
    seconds: float           # the window
    setup_s: float
    events: list             # serve.Event, stamped
    reqs: list               # traffic.Req
    rows: list               # the engine's iter_log rows of the run
    slots: int
    mask_id: int
    peak: Optional[dict]     # the card's published peaks (None off it)
    trace: Optional[tracing.TraceData] = None
    token_params: Optional[int] = None   # the reference's count a token


@dataclass
class Window:
    seed: int
    run: Run
    failed: int              # requests due in the window rejected or shed
    memory_peak_bytes: int   # the allocator's reserved peak so far
    running: list = field(default_factory=list)   # (t, running requests)
    waiting_at_end: int = 0  # requests due in the window still waiting
    prof: object = None      # the stopped profiler of a traced window


class Session:
    def __init__(self, cell: spec.Cell, seed: int, device: torch.device,
                 t_start: Optional[float] = None, log=lambda *a: None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.cell = cell
        self.device = device
        self.model = cell.config["model"]
        self.mask_id = self.model["vocab_size"] - 1
        self.kind = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
        self.layout = weights.layout(cell.config, cell.root)
        self.token_params = flops.token_params(cell.config, cell.root)
        self.params = weights.make(self.layout, self.model["dtype"], seed,
                                   device)
        self.drawn = seed
        self.stamps = serve.Stamps()
        self.built = serve.build(cell.config, self.params, device, seed,
                                 self.stamps)
        self.windows = 0
        log(f"servebench: {cell.name} seed {seed}: {self.built.slots} slots "
            f"(re-sized from {self.built.resized_from}), warmup "
            f"{self.built.warmup_s} s")

    def draw(self, seed: int) -> None:
        """The weights of ``seed``, in place."""
        if seed != self.drawn:
            weights.draw(self.params, self.layout, seed)
            self.drawn = seed

    def window(self, seed: int, seconds: float, mix: Optional[dict] = None,
               trace: bool = False, count_running: bool = False) -> Window:
        """Serve ``seed``'s traffic (the cell's mix, or ``mix``) for one
        window. The first window's ``setup_s`` runs from ``t_start`` to
        its opening; with ``trace`` the window runs under the profiler,
        whose data is read once the program's state is freed."""
        eng = self.built.engine
        if self.windows:
            serve.reset(eng)
        self.draw(seed)
        s = self.cell.config["serve"]
        reqs = traffic.build(mix or self.cell.traffic, seed,
                             slots=self.built.slots,
                             vocab_size=self.model["vocab_size"],
                             block_size=s["block_size"],
                             max_seq_len=s["max_seq_len"])
        handles = serve.submit(eng, reqs)
        self.stamps.running = ((lambda: len(eng.scheduler.running))
                               if count_running else None)
        prof = None
        if trace:
            tracing.label_phases(eng)
            prof = tracing.profiler()
            prof.start()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        setup_s = time.perf_counter() - self.t_start
        if trace:
            with torch.profiler.record_function(tracing.WINDOW):
                serve.run_window(eng, self.stamps, seconds)
            prof.stop()
        else:
            serve.run_window(eng, self.stamps, seconds)
        self.stamps.running = None
        self.windows += 1
        # what the program held on the card, its captured graphs' pool and
        # set-up included, read before any reference runs
        mem = (torch.cuda.max_memory_reserved(self.device)
               if self.device.type == "cuda" else 0)
        failed = sum(1 for h, r in zip(handles, reqs)
                     if r.due < seconds and h.state.value in ("rejected",
                                                              "shed"))
        waiting = sum(1 for r in eng.scheduler.waiting if r.arrival < seconds)
        run = Run(self.cell.name, self.cell.config, seconds, setup_s,
                  self.stamps.events, reqs, list(eng.stats.iter_log),
                  self.built.slots, self.mask_id, None,
                  token_params=self.token_params)
        return Window(seed, run, failed, int(mem), self.stamps.samples,
                      waiting, prof)

    def close(self) -> None:
        """Free the program's device state (the slot pool, the graphs)."""
        serve.release(self.built)
