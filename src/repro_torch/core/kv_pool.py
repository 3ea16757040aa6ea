"""Slot-granular static KV pool (paper §4.5 "Static Allocation and
Contiguous Storage").

One device-resident cache tree whose second axis, in every leaf, is the
request slot: a ``PackedKV`` (``k/v [L, slots+1, K, retain, dh]``,
``pos/valid [L, slots+1, K, retain]``), an ``SSMCache`` or a
``HybridCache`` (named tuples of tensors, nested). The extra slot, at index
``max_slots``, is scratch for padding rows. Refresh
writes a freshly packed cache into its requests' slots in place
(``index_copy_``, the form the reference's donated scatter takes here);
Reuse gathers the slots of its sub-batch. Both stay on the device.

Slot lifecycle: :meth:`take` / :meth:`free` keep a free-set plus a per-slot
generation counter; ``free`` bumps the generation so a stale holder is
detectable. Double-free and double-take raise.

Content-addressed sharing and int8 slot storage are not ported yet
(ROADMAP Queue A, 'robustness and the memory multipliers').
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch


def tree_leaves(cache) -> List[torch.Tensor]:
    """The tensors of a cache tree (nested named tuples), in field order."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for field in cache for t in tree_leaves(field)]


def tree_map(fn: Callable, cache):
    """The same cache tree with ``fn`` applied to every tensor."""
    if isinstance(cache, torch.Tensor):
        return fn(cache)
    return type(cache)(*[tree_map(fn, field) for field in cache])


class KVPool:
    def __init__(self, max_slots: int, device, sharing: bool = False,
                 kv_quant: str = "none"):
        if sharing or kv_quant != "none":
            raise NotImplementedError(
                "KVPool: prefix sharing and int8 slot storage are not ported "
                "yet (ROADMAP Queue A, 'robustness and the memory "
                "multipliers')")
        self.max_slots = max_slots
        self.scratch_slot = max_slots
        self.device = torch.device(device)
        self.cache = None          # cache tree, slot axis = 1
        self._free = set(range(max_slots))
        self._gen = np.zeros(max_slots + 1, np.int64)

    # -- slot lifecycle ----------------------------------------------------
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
        before any mutation."""
        for s in slots:
            if s in self._free:
                raise RuntimeError(f"KVPool: double-free of slot {s}")
            if not 0 <= s < self.max_slots:
                raise RuntimeError(f"KVPool: free of invalid slot {s}")
        for s in slots:
            self._free.add(s)
            self._gen[s] += 1

    def generation(self, slot: int) -> int:
        return int(self._gen[slot])

    # -- content -----------------------------------------------------------
    def ensure(self, cache_example) -> None:
        """Allocate the pool from the first Refresh output's shapes."""
        if self.cache is not None:
            return
        n = self.max_slots + 1
        self.cache = tree_map(
            lambda c: torch.zeros((c.shape[0], n) + tuple(c.shape[2:]),
                                  dtype=c.dtype, device=self.device),
            cache_example)

    def _index(self, slots) -> torch.Tensor:
        if isinstance(slots, torch.Tensor):
            return slots
        return torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)

    def write(self, slots, cache) -> None:
        """Scatter ``cache`` (slot axis 1) into ``slots`` (a list, or an
        int64 tensor on the pool's device, as the stage entries pass it),
        in place. Repeated scratch-slot entries (padding rows) race,
        harmlessly."""
        self.ensure(cache)
        idx = self._index(slots)
        for dst, src in zip(tree_leaves(self.cache), tree_leaves(cache)):
            dst.index_copy_(1, idx, src)

    def gather(self, slots):
        idx = self._index(slots)
        return tree_map(lambda t: t.index_select(1, idx), self.cache)

    def clear_slot(self, slot: int) -> None:
        """Zero one slot in every leaf (the scratch slot after warmup)."""
        if self.cache is not None:
            for t in tree_leaves(self.cache):
                t[:, slot].zero_()
