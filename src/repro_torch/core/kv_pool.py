"""Slot-granular static KV pool (paper §4.5 "Static Allocation and
Contiguous Storage").

One device-resident cache tree whose second axis, in every leaf, is the
request slot: a ``PackedKV`` (``k/v [L, slots+1, K, retain, dh]``,
``pos/valid [L, slots+1, K, retain]``), an ``SSMCache`` or a
``HybridCache`` (named tuples of tensors, nested). The extra slot, at index
``max_slots``, is scratch for padding rows. Refresh
writes a freshly packed cache into its requests' slots in place
(``index_copy_``, the form the reference's donated scatter takes here);
Reuse gathers the slots of its sub-batch. Both stay on the device, and
both run inside the captured stage entries: the host only rewrites the
slot-index tensor an entry takes.

Slot lifecycle: :meth:`take` / :meth:`free` keep a free-set plus a per-slot
generation counter; ``free`` bumps the generation so a stale holder is
detectable. Double-free and double-take raise.

Content-addressed sharing (``sharing=True``), as the reference's: a
:class:`~repro_torch.core.share_ledger.ShareLedger` sits between logical
slots and physical rows. :meth:`route_shared` records each Refresh row's
content key and returns the slots its scatter writes: a row whose key is
already resident goes to the scratch slot (the write is skipped; the
logical slot becomes a referrer of the owning row). :meth:`resolve` maps
referrers to their owner for the Reuse gathers, and :meth:`free` releases
references. Owned bytes that other slots still reference are promoted to a
surviving referrer by one device row copy (:meth:`_copy_row`), eager on
the serving stream, issued before the replay that overwrites the old
owner — copy-on-write in both the divergent-Refresh and the
free-while-shared direction. Generations stay logical, so preemption
composes with sharing unchanged.

int8 slot storage (``kv_quant="int8"``): the pool's float KV leaves are
stored quantized with per-(layer, slot) float32 scales
(``kernels.kv_quant``); the pool is then ``{"data": int8 tree, "scale":
{leaf: [L, slots+1]}}``. :meth:`write` quantizes, :meth:`gather` returns
that quantized view, and the Reuse entries dequantize at their KV load
(``kernels.ops.dequantize_gathered``).

On a serving mesh (``mesh`` and the pool's ``Rules.cache`` ``spec``, as the
reference's sharded pool): the slot axis, padded by ``pad_slots`` to a
multiple of the data-parallel axes' size, shards over them together
(``launch.mesh.data_axes``: ``data``, or ``('pod', 'data')`` on a 3-D
mesh; data-parallel rank i holds rows
``[i·n, (i+1)·n)``, plus one sink row that absorbs the writes of rows it
does not own), and within a slot the KV heads or SSM state heads are the
rank's own (the stage computes them per shard), while a retained length
the spec shards over ``model`` (KV heads that do not divide) is cut from
the whole cache the stage computed. :meth:`write` stores only this rank's
rows and shard; :meth:`gather` returns every requested row on every data
rank (each owner contributes its rows, then one ``all_reduce`` over the
data axes: exact, every other rank adds zeros), each leaf still the
rank's shard: a Reuse attends its cut of the retained length and merges
across the model axis (``ServeContext.kv_split``); a promote copy between
rows of different data ranks travels the same way. The slot ledger stays
on the host, identical on every rank.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.share_ledger import ShareLedger
from repro_torch.launch.mesh import axis_size, data_axes


def tree_leaves(tree) -> list:
    """The leaves of a cache tree (nested named tuples, tuples, lists and
    dicts, a dict in sorted key order: ``jax.tree.leaves``' order), in
    field order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for field in tree for t in tree_leaves(field)]
    return [tree]


def tree_map_i(fn: Callable, tree):
    """:func:`tree_map` with ``fn(i, leaf)`` at the ``i``-th leaf."""
    index = itertools.count()
    return tree_map(lambda leaf: fn(next(index), leaf), tree)


def tree_map(fn: Callable, tree):
    """The same tree with ``fn`` applied to every leaf, in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        fields = [tree_map(fn, f) for f in tree]
        return (type(tree)(*fields) if hasattr(tree, "_fields")
                else type(tree)(fields))
    return fn(tree)


class KVPool:
    def __init__(self, max_slots: int, device, sharing: bool = False,
                 kv_quant: str = "none", mesh=None, spec=None,
                 pad_slots: int = 0):
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"KVPool: kv_quant must be 'none' or 'int8', "
                             f"got {kv_quant!r}")
        if mesh is not None and kv_quant != "none":
            raise NotImplementedError("KVPool: int8 slots on a mesh")
        self.max_slots = max_slots
        self.scratch_slot = max_slots
        self.device = torch.device(device)
        self.kv_quant = kv_quant
        self.ledger: Optional[ShareLedger] = ShareLedger() if sharing \
            else None
        self.phys_peak = 0         # high-water distinct-owner occupancy
        self.cache = None          # cache tree, slot axis = 1
        self._dtypes = None        # pre-quantization leaf dtypes (by index)
        self._free = set(range(max_slots))
        self._gen = np.zeros(max_slots + 1, np.int64)
        self._layout(mesh, spec, pad_slots)

    def _layout(self, mesh, spec, pad_slots: int) -> None:
        """The mesh layout: rows this data-parallel rank owns, and per leaf
        the dimension cut over ``model`` from the stage's whole cache
        (None: none) and whether its head axis (2) is the rank's own."""
        self.mesh = mesh
        self._dp = data_axes(mesh) if mesh is not None else ()
        d = axis_size(mesh, self._dp) if mesh is not None else 1
        rows = self.max_slots + 1 + pad_slots
        if rows % d:
            raise ValueError(f"KVPool: {rows} rows do not divide the "
                             f"{d}-way data axes")
        self._dsplit = d > 1
        self._n_loc = rows // d
        self._lo = (mesh.index(self._dp) if d > 1 else 0) * self._n_loc
        self._cut: List[Optional[int]] = []
        self._head_split: List[bool] = []
        if mesh is not None and mesh.shape["model"] > 1:
            from repro_torch.launch.sharding import spec_axes, spec_leaves
            for sp in spec_leaves(spec):
                named = [i for i, e in enumerate(sp)
                         if "model" in spec_axes(e)]
                self._cut.append(next((i for i in named if i != 2), None))
                self._head_split.append(2 in named)

    def _owned(self, idx: torch.Tensor):
        """(owned mask, local row) of global slot indices; rows another
        data-parallel rank owns map to the sink row."""
        own = (idx >= self._lo) & (idx < self._lo + self._n_loc)
        return own, torch.where(own, idx - self._lo,
                                torch.full_like(idx, self._n_loc))

    def _cut_leaf(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the ``i``-th leaf of a stage's cache."""
        dim = self._cut[i] if self._cut else None
        if dim is None:
            return t
        m = self.mesh.shape["model"]
        n = t.shape[dim] // m
        return t.narrow(dim, self.mesh.index("model") * n, n)

    # -- slot lifecycle ----------------------------------------------------
    @property
    def slots_in_use(self) -> list:
        return sorted(set(range(self.max_slots)) - self._free)

    @property
    def phys_slots_in_use(self) -> int:
        """Distinct content-holding rows: with sharing the ledger's owner
        count, without it the logical slots in use."""
        if self.ledger is not None:
            return self.ledger.phys_slots
        return self.max_slots - len(self._free)

    def shared_refs(self, slot: int) -> int:
        """Live references backed by ``slot`` (0 without sharing); the
        scheduler's preemption prefers victims that own no shared bytes."""
        return self.ledger.refcount(slot) if self.ledger is not None else 0

    def take(self, slot: int) -> int:
        """Claim ``slot``; returns its current generation. Raises if it is
        already in use."""
        if slot not in self._free:
            raise RuntimeError(f"KVPool: slot {slot} taken while in use "
                               f"(free={sorted(self._free)})")
        self._free.discard(slot)
        return int(self._gen[slot])

    def free(self, slots: Sequence[int]) -> None:
        """Return slots, bumping each generation. Raises on double-free,
        before any mutation. With sharing each slot's reference is released
        first, and bytes other slots still reference are promoted."""
        for s in slots:
            if s in self._free:
                raise RuntimeError(f"KVPool: double-free of slot {s}")
            if not 0 <= s < self.max_slots:
                raise RuntimeError(f"KVPool: free of invalid slot {s}")
        for s in slots:
            if self.ledger is not None:
                promote = self.ledger.release(s)
                if promote is not None:
                    self._copy_row(*promote)
            self._free.add(s)
            self._gen[s] += 1

    def generation(self, slot: int) -> int:
        return int(self._gen[slot])

    # -- content -----------------------------------------------------------
    def ensure(self, cache_example) -> None:
        """Allocate the pool from the first Refresh output's shapes."""
        if self.cache is not None:
            return
        n = self._n_loc + 1 if self._dsplit else self.max_slots + 1

        def alloc(c, dtype=None):
            return torch.zeros((c.shape[0], n) + tuple(c.shape[2:]),
                               dtype=dtype or c.dtype, device=self.device)

        if self.mesh is not None:
            self.cache = tree_map_i(lambda i, c: alloc(self._cut_leaf(i, c)),
                                    cache_example)
            return

        if self.kv_quant == "int8":
            from repro_torch.kernels import kv_quant as KQ
            leaves = tree_leaves(cache_example)
            flags = KQ.quant_leaf_flags(cache_example)
            self._dtypes = {str(i): leaf.dtype
                            for i, (leaf, q) in enumerate(zip(leaves, flags))
                            if q}
            data = KQ.map_leaves(
                lambda i, c: alloc(c, torch.int8 if flags[i] else None),
                cache_example)
            scale = {k: torch.zeros((leaves[int(k)].shape[0], n),
                                    dtype=torch.float32, device=self.device)
                     for k in self._dtypes}
            self.cache = {"data": data, "scale": scale}
        else:
            self.cache = tree_map(alloc, cache_example)

    def slot_bytes(self) -> int:
        """Device bytes one slot takes across the pool's leaves (int8 data
        and its scales included; on a mesh, this device's shard of it); 0
        before the pool exists."""
        if self.cache is None:
            return 0
        return sum(t.nbytes // t.shape[1] for t in tree_leaves(self.cache))

    @property
    def rows(self) -> int:
        """Rows of the pool this device holds: every slot and the scratch
        slot, or on a data axis its share and the sink row."""
        return self._n_loc + 1 if self._dsplit else self.max_slots + 1

    @property
    def gathered_dtypes(self):
        """Pre-quantization leaf dtypes for ``dequantize_gathered`` (None
        until the pool exists, or when storage is exact)."""
        return self._dtypes

    def _index(self, slots) -> torch.Tensor:
        if isinstance(slots, torch.Tensor):
            return slots
        return torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)

    def write(self, slots, cache) -> None:
        """Scatter ``cache`` (slot axis 1) into ``slots`` (a list, or an
        int64 tensor on the pool's device, as the stage entries pass it),
        in place; int8 storage quantizes first. Repeated scratch-slot
        entries (padding rows, deduplicated rows) race, harmlessly."""
        self.ensure(cache)
        idx = self._index(slots)
        if self.mesh is not None:
            if self._dsplit:
                idx = self._owned(idx)[1]
            for i, (dst, src) in enumerate(zip(tree_leaves(self.cache),
                                               tree_leaves(cache))):
                dst.index_copy_(1, idx, self._cut_leaf(i, src))
            return
        if self.kv_quant == "int8":
            from repro_torch.kernels import kv_quant as KQ
            cache, scales = KQ.quantize_slot_leaves(cache)
            for k, s in scales.items():
                self.cache["scale"][k].index_copy_(1, idx, s)
            dst_tree = self.cache["data"]
        else:
            dst_tree = self.cache
        for dst, src in zip(tree_leaves(dst_tree), tree_leaves(cache)):
            dst.index_copy_(1, idx, src)

    def gather(self, slots):
        """The rows of ``slots`` (physical rows: see :meth:`resolve`); the
        quantized view ``{"data", "scale"}`` under int8; on a mesh, this
        rank's shard of each."""
        idx = self._index(slots)
        if self.mesh is None:
            return tree_map(lambda t: t.index_select(1, idx), self.cache)
        mesh = self.mesh
        if self._dsplit:
            own, li = self._owned(idx)

            def rows(t):
                r = t.index_select(1, li)
                mask = own.view((1, -1) + (1,) * (t.dim() - 2))
                return mesh.all_reduce(r.masked_fill(~mask, 0), self._dp)
        else:
            def rows(t):
                return t.index_select(1, idx)

        return tree_map(rows, self.cache)

    def full_cache(self):
        """Every slot of the pool (the scratch slot's included), whole, on
        every rank: what one device's pool holds. A collective on a
        mesh."""
        cache = self.gather(list(range(self.max_slots + 1)))
        if self.mesh is None or not self._cut:
            return cache

        def whole(i, t):
            for dim in (self._cut[i], 2 if self._head_split[i] else None):
                if dim is not None:
                    t = self.mesh.all_gather(t, "model", dim=dim)
            return t
        return tree_map_i(whole, cache)

    def clear_slot(self, slot: int) -> None:
        """Zero one slot in every leaf (the scratch slot after warmup)."""
        if self.cache is None:
            return
        if self._dsplit:
            if not self._lo <= slot < self._lo + self._n_loc:
                return
            slot -= self._lo
        for t in tree_leaves(self.cache):
            t[:, slot].zero_()

    # -- sharing -----------------------------------------------------------
    def _copy_row(self, src: int, dst: int) -> None:
        """Device row copy ``src -> dst`` (the COW promote), queued on the
        current stream behind every stage it was issued after. A slice
        copy: no index tensor to upload, so no host sync. A no-op before
        the pool exists (it holds no bytes to preserve then)."""
        if self.cache is None:
            return
        if self._dsplit:
            self._copy_row_across(src, dst)
            return
        for t in tree_leaves(self.cache):
            t.narrow(1, dst, 1).copy_(t.narrow(1, src, 1))

    def _copy_row_across(self, src: int, dst: int) -> None:
        """:meth:`_copy_row` on a data-sharded pool: a copy within one
        data-parallel rank's rows stays local; across ranks the source row
        reaches the destination's owner through an ``all_reduce`` over the
        data axes (every other rank adds zeros), which every rank joins."""
        lo, n = self._lo, self._n_loc
        src_own, dst_own = src // n, dst // n
        me = self.mesh.index(self._dp)
        for t in tree_leaves(self.cache):
            if src_own == dst_own:
                if me == src_own:
                    t.narrow(1, dst - lo, 1).copy_(t.narrow(1, src - lo, 1))
                continue
            row = (t.narrow(1, src - lo, 1) if me == src_own
                   else torch.zeros_like(t.narrow(1, 0, 1)))
            row = self.mesh.all_reduce(row, self._dp)
            if me == dst_own:
                t.narrow(1, dst - lo, 1).copy_(row)

    def warm_aux(self) -> None:
        """Run the promote copy once (scratch -> scratch, content
        irrelevant), as the reference warms its copy jit, so a sharing
        pool's first promote is no first launch mid-serve. No-op without
        sharing."""
        if self.ledger is not None and self.cache is not None:
            self._copy_row(self.scratch_slot, self.scratch_slot)

    def resolve(self, slots: Sequence[int]) -> List[int]:
        """The physical rows backing ``slots``: referrers read their
        owner's row (the identity without sharing)."""
        if self.ledger is None:
            return list(slots)
        return [self.ledger.resolve(s) for s in slots]

    def route_shared(self, slots: Sequence[int],
                     keys: Sequence[Optional[bytes]]) -> List[int]:
        """Record one Refresh batch's content keys in the ledger and return
        the slots its scatter writes: a row whose key already has an owner
        goes to the scratch slot (the logical slot becomes a referrer).
        Divergent rows promote their old content first (device copies
        issued now, ahead of the scatter). ``keys[j] is None`` (padding and
        warmup rows) and the scratch slot bypass the ledger."""
        if self.ledger is None:
            raise RuntimeError("KVPool: route_shared on a pool constructed "
                               "without sharing=True")
        scatter = list(slots)
        for j, (s, key) in enumerate(zip(slots, keys)):
            if key is None or not 0 <= s < self.max_slots:
                continue
            do_write, promote = self.ledger.record_write(s, key)
            if promote is not None:
                self._copy_row(*promote)
            if not do_write:
                scatter[j] = self.scratch_slot
        self.phys_peak = max(self.phys_peak, self.ledger.phys_slots)
        return scatter

    def write_shared(self, slots: Sequence[int], cache,
                     keys: Sequence[Optional[bytes]]) -> None:
        """Content-aware write: :meth:`route_shared`, then one scatter of
        the whole batch (the reference's ``write_shared``)."""
        self.ensure(cache)
        self.write(self.route_shared(slots, keys), cache)
