"""Content-addressed slot sharing: the refcount layer under KVPool, a copy
of ``repro.core.share_ledger`` (pure host code; the keys are the
reference's byte for byte).

Production dLLM traffic mostly repeats itself — shared system prompts,
duplicated prompts from retries and fan-out — and the slot-granular pool
bills that KV once **per request**. This module is the pure host-side half
of the fix: a block-chained content hash over the inputs that determine a
Refresh capture (:func:`block_chain_key`), and a :class:`ShareLedger`
mapping content keys to the one *owner* slot that physically holds the
bytes, with every other logical slot recorded as a *referrer* that
redirects its gathers to the owner.

Design:

* **Write-time dedup, reserved backing.** Every admitted request still
  owns a physical slot (scheduler admission arithmetic is untouched, so
  scheduling — and therefore token output — is bit-identical with sharing
  on or off). What sharing removes is the *write*: a Refresh whose content
  key already has an owner skips the device scatter and records a
  redirect instead. Savings show up as distinct-owner occupancy
  (``phys_slots`` < residents) and as skipped write bandwidth, and
  ``plan_memory`` converts the measured share factor into logical
  capacity.
* **Copy-on-write on divergence.** The first Refresh whose key differs
  from the slot's current key releases the old reference. If the slot
  *owned* content that others still reference, the content is promoted to
  the lowest-numbered referrer via one device row-copy before the
  diverging write lands — referrers never observe torn state.
* **Refcount-aware free.** ``KVPool.free`` routes through
  :meth:`ShareLedger.release`; freeing an owner with live referrers also
  promotes. Refcounts can never go below zero and a slot is never freed
  while referenced — the hypothesis suites (``tests/test_kv_share.py``,
  ``tests/test_torch_kv_share.py``) drive random interleavings against a
  model store.

The ledger is deliberately device-free (plain dicts/sets) so property
tests run thousands of interleavings without touching a device; the device
copy a promote requires is returned to the caller (KVPool) as a
``(src, dst)`` pair to execute.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Dict, Optional, Set, Tuple

import numpy as np


def block_chain_key(tokens: np.ndarray, block_size: int,
                    extra: bytes = b"") -> bytes:
    """Chained block hash of a token array: ``h_i = H(h_{i-1} || block_i)``.

    Hashing in ``block_size`` chunks keeps the digest a *prefix chain* —
    two sequences share the chain value after ``i`` blocks iff their first
    ``i`` blocks are identical — which is the natural granularity for a
    future sub-slot paged pool. The final chain value (xored into
    ``extra``-derived metadata by :func:`content_key`) addresses the whole
    slot. 128-bit blake2b: collisions are out of reach, and the e2e
    bit-identity suites would surface one loudly anyway.
    """
    t = np.ascontiguousarray(np.asarray(tokens, np.int32))
    bs = max(1, int(block_size))
    h = hashlib.blake2b(extra, digest_size=16)
    for off in range(0, t.size, bs):
        h = hashlib.blake2b(t[off: off + bs].tobytes(), key=h.digest(),
                            digest_size=16)
    return h.digest()


def content_key(tokens: np.ndarray, block_size: int, total_len: int,
                block_start: int, frontend: Optional[np.ndarray]) -> bytes:
    """Content address of one Refresh capture.

    Covers every input the captured cache is a deterministic function of:
    the full (padded) token array as a block chain, the live length and
    active-block offset (two requests with identical token bytes but
    different geometry must not collide), and the frontend payload for
    modality archs. Static config/params are engine-constant — keys are
    only ever compared within one engine.
    """
    meta = struct.pack("<qq", int(total_len), int(block_start))
    if frontend is not None:
        meta += hashlib.blake2b(
            np.ascontiguousarray(frontend).tobytes(),
            digest_size=16).digest()
    return block_chain_key(tokens, block_size, extra=meta)


class ShareLedger:
    """Host-side refcounted content→slot map (no device state).

    Invariants (property-tested in ``tests/test_torch_kv_share.py``):

    * every tracked slot resolves to exactly one owner;
    * an owner's referrer set always contains the owner itself;
    * ``refcount(s) >= 1`` for every owner, 0 for untracked slots —
      never negative;
    * each content key has at most one owner (``slot_of`` is injective);
    * a promote only ever moves content to a *live referrer* of the old
      owner.
    """

    def __init__(self) -> None:
        self.owner_of: Dict[int, int] = {}      # any tracked slot -> owner
        self.referrers: Dict[int, Set[int]] = {}  # owner -> tracked slots
        self.key_of: Dict[int, bytes] = {}      # owner -> content key
        self.slot_of: Dict[bytes, int] = {}     # content key -> owner
        # counters (engine stats surface these)
        self.hits = 0            # writes deduplicated against a live owner
        self.cow_promotes = 0    # divergence/release promotes (device copies)

    # -- queries -----------------------------------------------------------
    def resolve(self, slot: int) -> int:
        """Physical slot whose bytes back ``slot``'s content."""
        return self.owner_of.get(slot, slot)

    def refcount(self, slot: int) -> int:
        """Number of logical slots backed by ``slot`` (0 = not an owner)."""
        return len(self.referrers.get(slot, ()))

    def is_shared_owner(self, slot: int) -> bool:
        """True when freeing ``slot`` would force a promote copy."""
        return len(self.referrers.get(slot, ())) > 1

    @property
    def phys_slots(self) -> int:
        """Distinct content-holding slots (the real occupancy)."""
        return len(self.key_of)

    # -- mutations ---------------------------------------------------------
    def _detach(self, slot: int) -> Optional[Tuple[int, int]]:
        """Drop ``slot``'s current reference (if any). Returns a
        ``(src, dst)`` device copy to execute when the detach orphans
        content that live referrers still need (promote-on-release)."""
        owner = self.owner_of.pop(slot, None)
        if owner is None:
            return None
        refs = self.referrers[owner]
        refs.discard(slot)
        if owner != slot:
            return None                    # plain referrer left; owner intact
        key = self.key_of.pop(owner)
        del self.slot_of[key]
        del self.referrers[owner]
        if not refs:
            return None                    # last holder gone; content dies
        # the owner's bytes outlive the owner: promote to the lowest
        # referrer (a deterministic choice: pools compare across runs)
        # before the old slot is reused
        dst = min(refs)
        self.owner_of.update({s: dst for s in refs})
        self.referrers[dst] = refs
        self.key_of[dst] = key
        self.slot_of[key] = dst
        self.cow_promotes += 1
        return (owner, dst)

    def record_write(self, slot: int, key: bytes
                     ) -> Tuple[bool, Optional[Tuple[int, int]]]:
        """Account one Refresh capture of ``key`` into logical ``slot``.

        Returns ``(do_write, promote)``: ``do_write`` is False when the
        content is already resident under an owner (the caller redirects
        the device scatter to scratch), and ``promote`` is an optional
        ``(src, dst)`` row copy the caller must execute *before* the
        scatter lands (copy-on-write: the slot diverged while owning
        shared bytes).
        """
        if self.owner_of.get(slot) is not None and \
                self.key_of.get(self.resolve(slot)) == key:
            return False, None             # unchanged content, same backing
        promote = self._detach(slot)
        owner = self.slot_of.get(key)
        if owner is not None:
            self.owner_of[slot] = owner
            self.referrers[owner].add(slot)
            self.hits += 1
            return False, promote
        self.owner_of[slot] = slot
        self.referrers[slot] = {slot}
        self.key_of[slot] = key
        self.slot_of[key] = slot
        return True, promote

    def release(self, slot: int) -> Optional[Tuple[int, int]]:
        """Forget ``slot`` entirely (KVPool.free / eviction). Returns the
        promote copy to execute when the freed slot owned shared bytes."""
        return self._detach(slot)

    # -- integrity ---------------------------------------------------------
    def check(self) -> None:
        """Assert the full invariant set (test hook; cheap enough to call
        after every chaos iteration)."""
        for s, o in self.owner_of.items():
            assert o in self.referrers, (s, o)
            assert s in self.referrers[o], (s, o)
            assert self.owner_of.get(o) == o, (s, o)
        for o, refs in self.referrers.items():
            assert refs, o
            assert o in refs and o in self.key_of, (o, refs)
            for s in refs:
                assert self.owner_of.get(s) == o, (o, s)
        assert set(self.key_of) == set(self.referrers)
        for o, k in self.key_of.items():
            assert self.slot_of[k] == o, (o, k)
        assert len(self.slot_of) == len(self.key_of)
