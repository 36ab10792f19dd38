"""Shared KV page pool: host-side allocator behind the paged serving engine.

A copy of ``repro.serve.kv_pool`` (the port imports nothing of ``repro``);
``tests/test_torch_engine.py`` runs the reference's pool tests against both.

The paper's scheduler hands every instance a slice of a SHARED machine
instead of statically partitioning the cluster per user; this is the same
move for KV memory. One pool of ``n_pages`` fixed-size pages backs every
slot; a slot owns an ordered list of pages (its page table) that grows a
page at a time as its request decodes and returns to the free list the
moment the request finishes or is preempted. Capacity is therefore pooled
across slots: eight slots over a 64-page pool can hold one 60-page request
plus seven short ones, where the fixed partition would cap each at 8.

Pages are REFERENCE COUNTED, not exclusively owned: identical prompt
prefixes (the millions-of-users case is a few system prompts times many
users) map onto the same physical pages. The copy-on-write lifecycle:

  * ``alloc``         -> private page, refcount 1, owner = the slot.
  * ``register_prefix`` pins a slot's prompt pages under a digest key
                      (refcount++ per page) so they outlive the request.
  * ``share``         -> a later slot whose prompt starts with a registered
                      prefix appends those pages to its table (refcount++)
                      instead of re-prefilling them.
  * any page with refcount > 1 is immutable (``owner`` = -2); before a
    slot writes into one — the partial boundary page at the divergence
    point, or the original owner's next decode token — the engine calls
    ``cow_page`` to swap in a fresh private copy (``models.lm.paged_copy``
    moves the payload device-side).
  * ``free_slot`` / ``drop_prefix`` decrement; a page returns to the free
    list only at refcount 0 — and ONLY those pages may be cleared
    device-side (``paged_clear`` on a still-referenced page would wipe a
    live prefix under its other readers).

This class is pure bookkeeping — numpy tables, python free list. The
device-side mirror (the paged cache tree and the gather or paged-kernel
attention paths) lives in ``repro_torch.models.lm``;
``repro_torch.serve.engine`` keeps the two in sync by pushing
``table_array()`` to the device as the step's page-table argument.

Invariants (``check()``; exercised in tests/test_torch_engine.py):
  * every page is free (refcount 0, owner -1) xor referenced, and its
    refcount equals (#slot tables holding it) + (#prefix entries);
  * ``owner`` is the slot iff exactly that slot holds the page and
    refcount == 1 (i.e. the page is writable); -2 when shared/pinned;
  * a slot's table is a -1-padded prefix in alloc order;
  * ``free_pages + used_pages == n_pages`` at all times.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

SHARED = -2          # owner sentinel: referenced by >1 reader or by a prefix


class PagePool:
    """Fixed-size page allocator: per-slot page tables, per-page refcounts,
    digest-keyed prefix index with copy-on-write sharing."""

    def __init__(self, n_pages: int, page_size: int, slots: int,
                 pages_per_slot: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.slots = slots
        self.pages_per_slot = pages_per_slot
        self.vcap = pages_per_slot * page_size   # per-slot virtual capacity
        self.table = np.full((slots, pages_per_slot), -1, np.int32)
        self.owner = np.full(n_pages, -1, np.int32)  # slot | -1 free | -2
        self.refcount = np.zeros(n_pages, np.int32)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))  # pop() = 0
        self._count = np.zeros(slots, np.int32)          # pages per slot
        # digest -> {tokens, pages, tick}; tick is an LRU stamp bumped on
        # every successful lookup so eviction drops the coldest prefix
        self._prefix: Dict[bytes, dict] = {}
        self._tick = 0
        self.stats = {"allocs": 0, "frees": 0, "alloc_failures": 0,
                      "watermark": 0, "shared": 0, "cow_copies": 0,
                      "prefix_evictions": 0}

    # -- queries -----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_pages / self.n_pages

    def n_allocated(self, slot: int) -> int:
        return int(self._count[slot])

    def pages_of(self, slot: int) -> List[int]:
        return [int(p) for p in self.table[slot, : self._count[slot]]]

    def pages_for_tokens(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache rows (ring-capped)."""
        n_tokens = min(n_tokens, self.vcap)
        return -(-n_tokens // self.page_size)

    def table_array(self) -> np.ndarray:
        """Snapshot for the device-side page-table argument."""
        return self.table.copy()

    def writable(self, slot: int, page: int) -> bool:
        """True when ``slot`` may write into ``page`` in place (sole ref)."""
        return int(self.owner[page]) == slot

    # -- mutation ----------------------------------------------------------
    def alloc(self, slot: int, n: int = 1) -> Optional[List[int]]:
        """Append ``n`` private pages to ``slot``'s table. All-or-nothing:
        returns the page ids, or None (counted in ``alloc_failures``) when
        the pool or the slot's table can't take them."""
        have = int(self._count[slot])
        if n < 0 or have + n > self.pages_per_slot or n > len(self._free):
            self.stats["alloc_failures"] += 1
            return None
        got = [self._free.pop() for _ in range(n)]
        for k, p in enumerate(got):
            self.table[slot, have + k] = p
            self.owner[p] = slot
            self.refcount[p] = 1
        self._count[slot] = have + n
        self.stats["allocs"] += n
        self.stats["watermark"] = max(self.stats["watermark"],
                                      self.used_pages)
        return got

    def share(self, slot: int, pages: List[int]) -> bool:
        """Map existing (referenced) pages into ``slot``'s table, in order,
        bumping refcounts — the warm-prefix admission path. All-or-nothing
        on table capacity."""
        have = int(self._count[slot])
        if have + len(pages) > self.pages_per_slot:
            self.stats["alloc_failures"] += 1
            return False
        for k, p in enumerate(pages):
            assert self.refcount[p] > 0, "sharing an unreferenced page"
            self.table[slot, have + k] = p
            self.refcount[p] += 1
            self.owner[p] = SHARED
        self._count[slot] = have + len(pages)
        self.stats["shared"] += len(pages)
        return True

    def cow_page(self, slot: int, k: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write break: replace the shared page at table index
        ``k`` of ``slot`` with a fresh private page. Returns (src, dst)
        page ids for the device-side payload copy, or None when the pool
        has no free page (caller must free capacity and retry)."""
        src = int(self.table[slot, k])
        assert src >= 0 and not self.writable(slot, src), "COW on private page"
        if not self._free:
            self.stats["alloc_failures"] += 1
            return None
        dst = self._free.pop()
        self.table[slot, k] = dst
        self.owner[dst] = slot
        self.refcount[dst] = 1
        self.refcount[src] -= 1
        self._refresh_owner(src)
        self.stats["cow_copies"] += 1
        self.stats["watermark"] = max(self.stats["watermark"],
                                      self.used_pages)
        return src, dst

    def free_slot(self, slot: int) -> List[int]:
        """Drop every reference ``slot`` holds. Returns ONLY the pages
        whose refcount hit 0 (now free) — the engine clears exactly those
        device-side; clearing a still-referenced page would wipe a live
        shared prefix for its other readers."""
        held = self.pages_of(slot)
        self.table[slot, :] = -1        # drop the row first so owner
        self._count[slot] = 0           # recomputation doesn't see it
        freed = []
        for p in held:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.owner[p] = -1
                self._free.append(p)
                freed.append(p)
            else:
                self._refresh_owner(p)
        self.stats["frees"] += len(freed)
        return freed

    # -- prefix index ------------------------------------------------------
    def register_prefix(self, key: bytes, tokens, pages: List[int]) -> bool:
        """Pin ``pages`` (holding the cache rows of ``tokens``) under
        ``key``. The registry holds one reference per page, so the prefix
        survives its originating slot's release. Idempotent per key."""
        if key in self._prefix or not pages:
            return False
        for p in pages:
            assert self.refcount[p] > 0, "registering an unreferenced page"
            self.refcount[p] += 1
            self.owner[p] = SHARED
        self._tick += 1
        self._prefix[key] = {"tokens": tuple(int(t) for t in tokens),
                             "pages": [int(p) for p in pages],
                             "tick": self._tick}
        return True

    def lookup_prefix(self, key: bytes, tokens) -> Optional[dict]:
        """Entry for ``key`` if registered AND its tokens are a prefix of
        ``tokens`` (digest collisions never corrupt output). Bumps LRU."""
        e = self._prefix.get(key)
        if e is None:
            return None
        n = len(e["tokens"])
        if tuple(int(t) for t in tokens[:n]) != e["tokens"]:
            return None
        self._tick += 1
        e["tick"] = self._tick
        return e

    def prefix_keys(self) -> List[bytes]:
        return list(self._prefix)

    def prefix_lengths(self) -> List[int]:
        """Distinct registered prefix lengths, longest first (the admission
        path digests the prompt at each candidate length)."""
        return sorted({len(e["tokens"]) for e in self._prefix.values()},
                      reverse=True)

    def drop_prefix(self, key: bytes) -> List[int]:
        """Unpin a prefix; returns pages freed by the drop (for clearing)."""
        e = self._prefix.pop(key, None)
        if e is None:
            return []
        freed = []
        for p in e["pages"]:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.owner[p] = -1
                self._free.append(p)
                freed.append(p)
            else:
                self._refresh_owner(p)
        self.stats["frees"] += len(freed)
        return freed

    def evict_prefixes(self, need: int) -> List[int]:
        """Drop least-recently-matched prefixes until ``need`` pages are
        free (or none would free anything). A pin whose pages are ALL
        still referenced by live slots is skipped: dropping it frees
        zero pages now and only destroys future warm admissions — the
        pin becomes evictable again once its sharers release. Returns
        all pages freed."""
        freed = []
        skipped: set = set()
        while self.free_pages < need:
            candidates = [k for k in self._prefix if k not in skipped]
            if not candidates:
                break
            key = min(candidates, key=lambda k: self._prefix[k]["tick"])
            if not any(int(self.refcount[p]) == 1
                       for p in self._prefix[key]["pages"]):
                skipped.add(key)          # would free nothing: keep the pin
                continue
            freed += self.drop_prefix(key)
            self.stats["prefix_evictions"] += 1
        return freed

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        for key in list(self._prefix):
            self.drop_prefix(key)
        for s in range(self.slots):
            self.free_slot(s)

    def _refresh_owner(self, p: int) -> None:
        """Recompute ``owner[p]`` after a refcount decrement: the sole
        referencing slot when the page became exclusively theirs again,
        else SHARED (still multi-ref or pinned only by a prefix)."""
        if self.refcount[p] == 0:
            self.owner[p] = -1
            return
        if self.refcount[p] == 1:
            holders = np.nonzero((self.table == p).any(axis=1))[0]
            if len(holders) == 1:
                self.owner[p] = int(holders[0])
                return
        self.owner[p] = SHARED

    def check(self) -> None:
        """Assert the allocator + refcount invariants (test hook)."""
        assert len(set(self._free)) == len(self._free), \
            "free list holds duplicates"
        refs = np.zeros(self.n_pages, np.int64)
        slot_refs: Dict[int, List[int]] = {}
        for s in range(self.slots):
            cnt = int(self._count[s])
            row = self.table[s]
            assert (row[cnt:] == -1).all(), "table not -1-padded"
            assert (row[:cnt] >= 0).all(), "hole in table prefix"
            for p in row[:cnt]:
                refs[int(p)] += 1
                slot_refs.setdefault(int(p), []).append(s)
        for e in self._prefix.values():
            for p in e["pages"]:
                refs[p] += 1
        free = set(self._free)
        for p in range(self.n_pages):
            rc = int(self.refcount[p])
            assert rc == refs[p], \
                f"page {p}: refcount {rc} != {refs[p]} references (orphan/leak)"
            if p in free:
                assert rc == 0, f"freed page {p} has refcount {rc}"
                assert int(self.owner[p]) == -1, f"freed page {p} has owner"
            else:
                assert rc > 0, f"page {p} neither free nor referenced"
                holders = slot_refs.get(p, [])
                if rc == 1 and len(holders) == 1:
                    assert int(self.owner[p]) == holders[0], \
                        f"page {p}: sole ref by slot {holders[0]} " \
                        f"but owner {self.owner[p]}"
                else:
                    assert int(self.owner[p]) == SHARED, \
                        f"page {p}: refcount {rc} but owner {self.owner[p]}"
        assert self.free_pages + self.used_pages == self.n_pages
