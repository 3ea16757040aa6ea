"""Per-bucket stage entries: the port's counterpart of the reference's jit
cache (``repro/core/engine.py`` ``_refresh_fn`` ... ``_decode_packed_fn``,
and the pool's scatter and gather jits of ``repro/core/kv_pool.py``).

One :class:`StageEntry` is one (stage, bucket): its static input buffers,
its function, and on the card its captured ``torch.cuda.CUDAGraph`` with
the graph's static outputs. The engine fills an entry's host streams in
numpy (:meth:`StageEntry.host`); a call copies them to the static device
inputs in ONE host->device copy from pinned memory and runs the entry.

* On the card with graphs (the default), the first call of an entry warms
  its function once eagerly (kernel attributes, library handles, the slot
  pool's first allocation) and then captures it, in the default ``global``
  capture mode, into a memory pool every entry shares. Every later call is
  a single ``replay``. A capture that fails raises and names the stage:
  nothing falls back to eager quietly.
* Without graphs (the oracle ``graphs=False``), and on the CPU, the entry
  runs its function eagerly on the same static inputs.

Rules the engine keeps:

* A graph captured later may place its intermediates over an earlier
  graph's static outputs (the pool is shared), so the caller copies every
  static output it needs into a buffer of its own right after the replay,
  before any other replay (one stream keeps that order on the device).
* Pinned staging is never overwritten while its copy may still be queued:
  :meth:`StageEntry.host` hands out a set whose last copy has completed,
  and allocates another when none has.
* Kernel wrappers count their launches on the host, which a replay never
  reaches: each entry records the counters' deltas during its capture (and
  takes them back out, since capture runs nothing) and adds them at every
  replay.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as kbuild

ALIGN = 16            # bytes; every field of a flat buffer starts aligned

_NP = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
       torch.float32: np.float32}


@dataclass(frozen=True)
class Field:
    """One static input: ``host=True`` fields are filled on the host and
    copied; the others are device buffers the engine writes on the device
    (the logit stage's hidden rows)."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: object = 0
    host: bool = True


def _layout(fields: List[Field]) -> Tuple[Dict[str, int], int]:
    off, total = {}, 0
    for f in fields:
        off[f.name] = total
        nb = int(np.prod(f.shape, dtype=np.int64)) * \
            torch.empty((), dtype=f.dtype).element_size()
        total += -(-nb // ALIGN) * ALIGN
    return off, max(total, ALIGN)


def _typed(buf: torch.Tensor, f: Field, off: int) -> torch.Tensor:
    n = int(np.prod(f.shape, dtype=np.int64))
    size = torch.empty((), dtype=f.dtype).element_size()
    return buf[off: off + n * size].view(f.dtype).view(f.shape)


class _Staging:
    """One pinned host copy of an entry's host fields, with the event of
    its last host->device copy."""

    def __init__(self, fields, off, total, pin: bool):
        self.buf = torch.empty((total,), dtype=torch.uint8, pin_memory=pin)
        # a host buffer's array view: no device read
        arr = self.buf.numpy()  # lint: allow(host-sync)
        self.views = {}
        for f in fields:
            n = int(np.prod(f.shape, dtype=np.int64))
            nb = n * np.dtype(_NP[f.dtype]).itemsize
            o = off[f.name]
            self.views[f.name] = arr[o: o + nb].view(_NP[f.dtype]).reshape(
                f.shape)
        self.event: Optional[torch.cuda.Event] = None
        self.held = False

    def free(self) -> bool:
        return not self.held and (self.event is None or self.event.query())


def _counts() -> Dict[str, Tuple[int, int]]:
    return {n: (c.launches, c.plain_calls)
            for n, c in kbuild.COUNTERS.items()}


class StageEntry:
    def __init__(self, graphs: "StageGraphs", name: str, key: tuple,
                 fields: List[Field], fn: Callable):
        self.name, self.key, self.fn = name, key, fn
        # what the entry needs of its owner, held without a reference back
        # (a cycle would leave graphs to the garbage collector)
        self.captures = graphs.capture
        self._stream, self._pool = graphs.stream, graphs.pool
        self._compile_counts = graphs.compile_counts
        dev = graphs.device
        self._host_fields = [f for f in fields if f.host]
        self._off, self._total = _layout(self._host_fields)
        self._cuda = dev.type == "cuda"
        self._staging: List[_Staging] = []
        self._cur: Optional[_Staging] = None
        # device bytes of the static inputs, outside the graph pool
        self.device_bytes = 0
        if self._cuda:
            self._dev_buf = torch.empty((self._total,), dtype=torch.uint8,
                                        device=dev)
            self.device_bytes = self._total
        else:
            # the CPU runs on the host buffer itself: no copy to make
            self._staging.append(_Staging(self._host_fields, self._off,
                                          self._total, pin=False))
            self._dev_buf = self._staging[0].buf
        self.inputs: Dict[str, torch.Tensor] = {
            f.name: _typed(self._dev_buf, f, self._off[f.name])
            for f in self._host_fields}
        for f in fields:
            if not f.host:
                t = torch.zeros(f.shape, dtype=f.dtype, device=dev)
                self.inputs[f.name] = t
                if self._cuda:
                    self.device_bytes += t.numel() * t.element_size()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.calls = 0
        self.replays = 0
        self._deltas: Dict[str, Tuple[int, int]] = {}
        self._outs: List[_Staging] = []

    @property
    def label(self) -> str:
        return f"{self.name}[{','.join(str(k) for k in self.key)}]"

    # -- inputs --------------------------------------------------------------
    def host(self) -> Dict[str, np.ndarray]:
        """Numpy views of a staging set whose last copy has run, every field
        reset to its fill value; the next call sends them."""
        cur = next((s for s in self._staging if s.free()), None)
        if cur is None:
            cur = _Staging(self._host_fields, self._off, self._total,
                           pin=True)
            self._staging.append(cur)
        for f in self._host_fields:
            cur.views[f.name][...] = f.fill
        self._cur = cur
        return cur.views

    def _upload(self) -> None:
        cur, self._cur = self._cur, None
        if cur is None:
            raise RuntimeError(f"{self.label}: called without host()")
        if not self._cuda or not self._host_fields:
            return
        self._dev_buf.copy_(cur.buf, non_blocking=True)
        cur.event = torch.cuda.Event()
        cur.event.record()

    # -- running -------------------------------------------------------------
    def __call__(self):
        """Send the staged inputs and run: replay the graph (capturing it on
        the first call), or run the function eagerly."""
        self._upload()
        self.calls += 1
        if not self.captures:
            return self.fn(self.inputs)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        for name, (dl, dp) in self._deltas.items():
            c = kbuild.counter(name)
            c.launches += dl
            c.plain_calls += dp
        return self.outputs

    def prepare(self) -> None:
        """Send the staged (dummy) inputs and, on the card with graphs, warm
        and capture the entry without replaying it."""
        self._upload()
        if self.captures and self.graph is None:
            self._capture()

    def _capture(self) -> None:
        s = self._stream
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            self.fn(self.inputs)          # eager warm-up: first-launch set-up
        before = _counts()
        g = torch.cuda.CUDAGraph()
        # torch.cuda.graph collects garbage before it begins; a collection
        # inside the capture (an engine's old graphs and pinned buffers
        # destroyed) would make calls a capturing stream forbids
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g, pool=self._pool, stream=s):
                out = self.fn(self.inputs)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of stage {self.label} "
                               f"failed: {e}") from e
        finally:
            if enabled:
                gc.enable()
        after = _counts()
        # capture records launches without running them: take them back
        for name, (l1, p1) in after.items():
            l0, p0 = before.get(name, (0, 0))
            if (l1 - l0) or (p1 - p0):
                self._deltas[name] = (l1 - l0, p1 - p0)
                c = kbuild.counter(name)
                c.launches, c.plain_calls = l0, p0
        self.graph, self.outputs = g, out
        self._compile_counts[self.name] = \
            self._compile_counts.get(self.name, 0) + 1

    # -- outputs -------------------------------------------------------------
    def to_host(self, t: torch.Tensor) -> "HostResult":
        """Queue one device->host copy of ``t`` into pinned memory (no wait;
        the result's :meth:`HostResult.wait` blocks on its event)."""
        if not self._cuda:
            return HostResult(t, None, None)
        f = Field("out", tuple(t.shape), t.dtype)
        out = next((s for s in self._outs if s.free()), None)
        if out is None:
            off, total = _layout([f])
            out = _Staging([f], off, total, pin=True)
            self._outs.append(out)
        dst = _typed(out.buf, f, 0)
        dst.copy_(t, non_blocking=True)
        out.event = torch.cuda.Event()
        out.event.record()
        out.held = True
        return HostResult(dst, out.event, out)


class HostResult:
    """A queued device->host copy: :meth:`wait` blocks on its event and
    returns the host array; :meth:`release` frees its pinned buffer."""

    def __init__(self, t: torch.Tensor, event, slot: Optional[_Staging]):
        # the host tensor's array view, filled when the event completes:
        # no device read
        self._arr = t.numpy()  # lint: allow(host-sync)
        self.event, self._slot = event, slot

    def wait(self) -> np.ndarray:
        if self.event is not None:
            # the serving loop's one deferred read of an iteration
            self.event.synchronize()  # lint: allow(host-sync)
        return self._arr

    def release(self) -> None:
        if self._slot is not None:
            self._slot.held = False
            self._slot = None


class StageGraphs:
    """Every entry of one engine, keyed (stage, bucket), with the memory
    pool and the capture stream their graphs share."""

    def __init__(self, device: torch.device, graphs: bool = True):
        self.device = torch.device(device)
        self.capture = bool(graphs) and self.device.type == "cuda"
        self.entries: Dict[Tuple[str, tuple], StageEntry] = {}
        self.compile_counts: Dict[str, int] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.stream = torch.cuda.Stream(self.device) if self.capture else None

    def get(self, name: str, key: tuple,
            make: Callable[[], Tuple[List[Field], Callable]]) -> StageEntry:
        """The entry of (name, key); ``make`` gives its fields and function
        the first time. Without graphs an entry counts as compiled when it
        is built; with them, when it is captured."""
        e = self.entries.get((name, key))
        if e is None:
            fields, fn = make()
            e = self.entries[(name, key)] = StageEntry(self, name, key,
                                                       fields, fn)
            if not self.capture:
                self.compile_counts[name] = \
                    self.compile_counts.get(name, 0) + 1
        return e

    @property
    def replays(self) -> Dict[str, int]:
        return {e.label: e.replays for e in self.entries.values()
                if e.replays}

    def staging_bytes(self) -> int:
        """Device bytes the entries' static inputs hold beside the graph
        pool: each entry's copy of its host-filled fields (a frontend
        arch's payloads, ``[rp, F, frontend_dim]`` float32 a packed Refresh
        bucket, dominate) and its device-side fields (the logit stage's
        hidden rows). 0 on the CPU, where an entry runs on its host
        buffer."""
        return sum(e.device_bytes for e in self.entries.values())

    def pool_bytes(self) -> int:
        """Bytes the shared graph pool holds (0 without graphs)."""
        if not self.capture:
            return 0
        snap = torch.cuda.memory_snapshot()
        pid = tuple(self.pool)
        return sum(seg["total_size"] for seg in snap
                   if tuple(seg.get("segment_pool_id", ())) == pid)
