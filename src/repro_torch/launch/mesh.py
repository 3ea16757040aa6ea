"""Serving meshes: the ``(data, model)`` or ``(pod, data, model)`` device
mesh of mesh serving, one process per mesh device (``repro.launch.mesh``).

The reference runs one process over a JAX device mesh and leaves the
collectives to GSPMD. The port runs one process per mesh device under
``torch.distributed``: :func:`spawn` starts the ranks (a ``FileStore`` in a
temp directory is their rendezvous, so concurrent runs never contend for a
port), :func:`make_serving_mesh` builds each rank's :class:`ServingMesh`
(``init_device_mesh`` and a group per axis, plus one over the data-parallel
axes together, :func:`data_axes`, when the pod axis is there), and the
model code calls the mesh's collectives where the reference's shardings
imply them. The pod axis is pure data parallelism, as in the reference: a
collective over the data axes runs over ``('pod', 'data')`` at once. The
backends:

* the CPU: gloo;
* CUDA, one GPU a rank: NCCL (unverified: no run of it has had two
  GPUs);
* CUDA, every rank on one GPU (``colocate=True``, a test arrangement that
  the shard-check tool and ``chip_smoke.py`` ask for): gloo, whose
  collectives here run on host tensors. A CUDA tensor is staged through
  pinned host memory, explicitly, in :class:`ServingMesh`.

A ``(1, 1)`` or ``(1, 1, 1)`` mesh builds no process group and issues no
collective: every helper is the identity on a group of one, so it is
bit-identical to no mesh.
A mesh larger than the visible GPUs raises (:func:`check_devices`); nothing
here ever falls back to one device.

:class:`SimMesh` is the device-free stand-in the memory planner bills any
mesh shape over (``axis_size`` consults nothing else); :class:`MetaMesh`
is rank 0 of any mesh on the meta device, whose collectives only shape
and log their results: the dry run and the grid audit run the model code
under it (:func:`using`).
"""
from __future__ import annotations

import contextlib
import gc
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch

def data_axes(mesh) -> tuple:
    """The axes batches shard over (pods fold into data parallelism)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _prod(dims) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


def axis_size(mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return mesh.shape[name]


def _axes_for(ndim: int) -> tuple:
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(ndim)
    if axes is None:
        raise ValueError(
            f"mesh shape needs 2 dims (data, model) or 3 (pod, data, "
            f"model), got {ndim} — e.g. --mesh 1,2 / REPRO_MESH=1,2")
    return axes


def parse_mesh_env(var: str = "REPRO_MESH"):
    """``ServeConfig.mesh_shape`` from the environment (``REPRO_MESH=1,2``);
    None when unset or empty."""
    raw = os.environ.get(var, "").strip()
    if not raw:
        return None
    return tuple(int(x) for x in raw.split(","))


def parse_mesh(arg: str):
    """A launcher's ``--mesh``: ``d,m`` or ``p,d,m``, ``none`` (no mesh) or
    ``env``
    (:func:`parse_mesh_env`)."""
    if arg == "env":
        return parse_mesh_env()
    if arg in ("none", ""):
        return None
    return tuple(int(x) for x in arg.split(","))


class SimMesh:
    """Device-free stand-in for a mesh: ``axis_names`` and the per-axis
    sizes only, which is all ``Rules`` and :func:`axis_size` read."""

    def __init__(self, shape, axes=None):
        shape = tuple(int(d) for d in shape)
        self.axis_names = tuple(axes) if axes else _axes_for(len(shape))
        assert len(self.axis_names) == len(shape), (shape, self.axis_names)
        self.shape = dict(zip(self.axis_names, shape))


class MetaMesh:
    """Shape-only stand-in for a :class:`ServingMesh`, for the dry run and
    the grid audit: rank 0 of a mesh of any shape, in one process, on the
    meta device. It has what ``params.shard_cut`` and
    ``sharding.local_slice`` read (``axis_names``, ``shape``, ``coords``)
    and the collectives the model code calls, which return tensors of the
    right shapes and log each result's bytes by kind (``log``: the raw
    result bytes, the reference's convention for its HLO collectives).
    ``all_reduce`` (a sum or a max: one kind, ``all-reduce``, as in the
    reference's HLO) and ``broadcast`` return a copy and ``all_gather`` a
    concatenation of ``x``, so autograd sees the same graph it would on a
    real mesh. Make it the active mesh with :func:`using`."""

    def __init__(self, shape):
        dims = tuple(int(d) for d in shape)
        self.axis_names = _axes_for(len(dims))
        self.shape = dict(zip(self.axis_names, dims))
        self.size = _prod(dims)
        self.coords = {a: 0 for a in self.axis_names}
        # the global kernel dimensions, for require_divisible (the caller's)
        self.kernel_dims: dict = {}
        self.log: dict = {}

    def index(self, axis) -> int:
        return 0

    def record(self, kind: str, out: torch.Tensor) -> torch.Tensor:
        """Log ``out``'s bytes under ``kind`` and return it."""
        self.log[kind] = (self.log.get(kind, 0)
                          + out.numel() * out.element_size())
        return out

    def all_reduce(self, x: torch.Tensor, axis,
                   op: str = "sum") -> torch.Tensor:
        _reduce_op(op)
        if axis_size(self, axis) == 1:
            return x
        return self.record("all-reduce", x.clone())

    def all_gather(self, x: torch.Tensor, axis,
                   dim: int = 0) -> torch.Tensor:
        n = axis_size(self, axis)
        if n == 1:
            return x
        return self.record("all-gather", torch.cat([x] * n, dim=dim))

    def stack_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        return self.all_gather(x[None], axis, dim=0)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.size == 1:
            return x
        return self.record("broadcast", x.clone())


def _reduce_op(op: str):
    """``torch.distributed.ReduceOp`` of an ``all_reduce``'s ``op``."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op must be 'sum' or 'max', got {op!r}")
    import torch.distributed as dist
    return dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX


def backend_for(device: torch.device, colocate: bool) -> str:
    """gloo on the CPU and for ranks sharing one GPU, NCCL for one GPU a
    rank."""
    return "nccl" if device.type == "cuda" and not colocate else "gloo"


def check_devices(mesh_shape, device, *, colocate: bool = False) -> None:
    """Raise ``ValueError`` when ``mesh_shape`` needs more GPUs than are
    visible (co-located ranks need one)."""
    world = _prod(mesh_shape)
    if torch.device(device).type != "cuda":
        return
    need = 1 if colocate else world
    have = torch.cuda.device_count()
    if have < need:
        how = "co-located ranks" if colocate else "one a rank"
        raise ValueError(
            f"a {'x'.join(map(str, mesh_shape))} mesh needs {need} visible "
            f"GPU{'s' if need > 1 else ''} ({how}), and {have} "
            f"{'is' if have == 1 else 'are'} visible")


class ServingMesh:
    """One rank's view of the ``(data, model)`` or ``(pod, data, model)``
    mesh: its coordinates (row-major over the axes), the groups and the
    collectives the model code calls. A collective names one axis or a
    tuple of axes (:func:`data_axes`), and is the identity when their
    combined size is 1."""

    def __init__(self, shape, device, rank: int = 0, groups=None,
                 backend: Optional[str] = None):
        self.dims = tuple(int(d) for d in shape)
        self.axis_names = _axes_for(len(self.dims))
        self.shape = dict(zip(self.axis_names, self.dims))
        self.size = _prod(self.dims)
        self.rank = rank
        self.coords, r = {}, rank
        for a, n in reversed(list(zip(self.axis_names, self.dims))):
            self.coords[a], r = r % n, r // n
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups or {}
        # gloo runs its collectives on host tensors here
        self.staged = backend == "gloo" and self.device.type == "cuda"
        # the global sizes of the kernel dimensions the model axis splits,
        # for the kernel wrappers' divisibility law (set by the engine)
        self.kernel_dims: dict = {}
        # seconds inside collectives (staging included) and their count
        self.collective_s = 0.0
        self.collectives = 0

    def index(self, axis) -> int:
        """This rank's index on ``axis``, or on a tuple of axes combined
        major to minor."""
        if isinstance(axis, str):
            return self.coords[axis]
        idx = 0
        for a in axis:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _group(self, axis):
        """The process group of ``axis`` (a name or a tuple of names); the
        axes of size 1 in a tuple drop out."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        axes = tuple(a for a in axes if self.shape[a] > 1)
        return self._groups[axes[0] if len(axes) == 1 else axes]

    def _collective(self, x: torch.Tensor, run: Callable) -> torch.Tensor:
        """``run(t)`` on ``x`` or its host copy, timed; bool tensors travel
        as uint8."""
        import torch.distributed as dist  # noqa: F401  (fail here if absent)
        if self.staged:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        dtype = x.dtype
        t = x.to(torch.uint8) if dtype == torch.bool else x
        if self.staged:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            out = run(host).to(self.device)
        else:
            out = run(t.contiguous())
        if dtype == torch.bool:
            out = out.bool()
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return out

    def all_reduce(self, x: torch.Tensor, axis,
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``) or the maximum (``op="max"``) of ``x``
        over ``axis`` (a name or a tuple of names); a new tensor."""
        reduce_op = _reduce_op(op)
        if axis_size(self, axis) == 1:
            return x
        import torch.distributed as dist
        group = self._group(axis)

        def run(t):
            t = t.clone()
            dist.all_reduce(t, op=reduce_op, group=group)
            return t
        return self._collective(x, run)

    def all_gather(self, x: torch.Tensor, axis,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` (a name or a tuple of names),
        concatenated on ``dim`` in the order of :meth:`index`."""
        n = axis_size(self, axis)
        if n == 1:
            return x
        import torch.distributed as dist
        group = self._group(axis)

        def run(t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts, dim=dim)
        return self._collective(x, run)

    def stack_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, stacked on a new leading
        dim."""
        return self.all_gather(x[None], axis, dim=0)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank of the mesh."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        def run(t):
            t = t.clone()
            dist.broadcast(t, src=src)
            return t
        return self._collective(x, run)

    def broadcast_float(self, v: float, src: int = 0) -> float:
        """Rank ``src``'s host float on every rank: a float64 on the host
        under gloo, on this rank's GPU under NCCL (which has no host
        tensors)."""
        if self.size == 1:
            return v
        import torch.distributed as dist
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor([v], dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        dist.broadcast(t, src=src)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return float(t.item())


_ACTIVE: Optional[ServingMesh] = None


def activate(mesh: Optional[ServingMesh]) -> None:
    """Make ``mesh`` the process's serving mesh (None: no mesh). One
    serving mesh a process: each rank of :func:`spawn` activates its own."""
    global _ACTIVE
    _ACTIVE = mesh


def active() -> Optional[ServingMesh]:
    return _ACTIVE


@contextlib.contextmanager
def using(mesh):
    """``mesh`` (a :class:`MetaMesh`) as the active mesh for the block;
    the previous one is restored on exit."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def tp() -> Optional[ServingMesh]:
    """The active mesh when its ``model`` axis splits work (size > 1),
    else None: the single-device code path."""
    m = _ACTIVE
    return m if m is not None and m.shape["model"] > 1 else None


def global_dim(mesh, kernel: str, dim: str) -> int:
    """The global size of a kernel dimension the mesh records
    (``kernel_dims``, set by the engine and the dry run)."""
    n = mesh.kernel_dims.get(dim)
    if n is None:
        raise ValueError(f"{kernel}: the serving mesh records no global "
                         f"size of {dim}")
    return n


def require_divisible(kernel: str, *dims: str) -> None:
    """The kernel wrappers' divisibility law under a model axis > 1 (as
    ``repro.kernels.ops._require_divisible``): each named global dimension
    must divide the axis, or the kernel would run on a shard that is not
    one."""
    mesh = tp()
    if mesh is None:
        return
    m = mesh.shape["model"]
    sizes = {d: global_dim(mesh, kernel, d) for d in dims}
    bad = [f"{d}={n}" for d, n in sizes.items() if n % m]
    if bad:
        raise ValueError(
            f"{kernel} cannot partition over the {m}-way model axis: "
            f"{', '.join(bad)} must divide it exactly")


def make_serving_mesh(mesh_shape, device, *, colocate: bool = False):
    """This process's :class:`ServingMesh` for ``mesh_shape`` (None: no
    mesh). A one-device mesh needs no process group. A larger one must run
    on ranks :func:`spawn` started (one process a device, the world the
    mesh's size): it takes a group per axis from ``init_device_mesh`` and,
    on a ``(pod, data, model)`` mesh whose pod and data axes both split,
    one over the two together (``new_group``, every rank creating every
    such group in the same order). Raises when the GPUs, the world or the backend do not match
    the mesh."""
    if not mesh_shape:
        return None
    shape = tuple(int(d) for d in mesh_shape)
    axes = _axes_for(len(shape))
    dev = torch.device(device)
    world = _prod(shape)
    if world == 1:
        return ServingMesh(shape, dev)
    check_devices(shape, dev, colocate=colocate)
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh runs one process per "
            f"device: start its {world} ranks through "
            f"repro_torch.launch.mesh.spawn")
    backend = dist.get_backend()
    want = backend_for(dev, colocate)
    if backend != want:
        raise ValueError(f"ranks on {dev.type}"
                         f"{' (co-located)' if colocate else ''} use "
                         f"{want}, not {backend}")
    from torch.distributed.device_mesh import init_device_mesh
    dmesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                             mesh_dim_names=axes)
    groups = {a: dmesh.get_group(a) for a in axes}
    rank = dist.get_rank()
    if len(shape) == 3 and min(shape[:2]) > 1:
        # the data-parallel axes together: the ranks of one model index
        m = shape[-1]
        for j in range(m):
            g = dist.new_group(list(range(j, world, m)))
            if rank % m == j:
                groups[("pod", "data")] = g
    return ServingMesh(shape, dev, rank, groups, backend)


def serving_mesh(mesh_shape, device) -> Optional[ServingMesh]:
    """The mesh an engine serves on: None without ``mesh_shape``; a
    one-device mesh in process; else this rank's active mesh, which must
    have that shape."""
    if not mesh_shape:
        return None
    shape = tuple(int(d) for d in mesh_shape)
    if _prod(shape) == 1:
        return ServingMesh(shape, device)
    mesh = _ACTIVE
    if mesh is None or mesh.dims != shape:
        have = "no mesh" if mesh is None else f"a {mesh.dims} mesh"
        raise RuntimeError(
            f"an engine on a {'x'.join(map(str, shape))} mesh runs on the "
            f"ranks of repro_torch.launch.mesh.spawn, and this process has "
            f"{have}")
    return mesh


def _rank_main(rank: int, fn: Callable, shape: tuple, device: str,
               colocate: bool, tmp: str, threads: int, args: tuple) -> None:
    import torch.distributed as dist
    torch.set_num_threads(threads)
    world = _prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if colocate else rank)
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend_for(dev, colocate), store=store,
                            rank=rank, world_size=world)
    try:
        mesh = make_serving_mesh(shape, dev, colocate=colocate)
        activate(mesh)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        # every reference to the groups and the store goes before they are
        # destroyed, so that their threads end here and not in the
        # interpreter's teardown, where gloo has aborted a finished rank
        activate(None)
        mesh = out = None
        gc.collect()
        dist.destroy_process_group()
        del store
        gc.collect()


def spawn(fn: Callable, mesh_shape, device="cpu", *args,
          colocate: bool = False) -> list:
    """Run ``fn(mesh, *args)`` on one process per device of ``mesh_shape``
    (``torch.multiprocessing``, spawned) and return each rank's result, in
    rank order (row-major over the mesh's axes: rank = data index · model
    size + model index on ``(data, model)``). ``fn`` must
    be importable by name; results travel through ``torch.save``. Each rank
    caps torch's threads at its share of this process's. A rank that
    raises ends the others, and its error propagates here."""
    import torch.multiprocessing as mp
    shape = tuple(int(d) for d in mesh_shape)
    _axes_for(len(shape))
    check_devices(shape, device, colocate=colocate)
    world = _prod(shape)
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    try:
        threads = max(1, torch.get_num_threads() // world)
        mp.start_processes(_rank_main,
                           args=(fn, shape, str(device), colocate, tmp,
                                 threads, args),
                           nprocs=world, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
