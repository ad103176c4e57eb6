"""Tier manager — the serving-side handle on the store's storage tiers.

Three tiers, cheapest first:

* **hot** — the store's decoded-block LRU (``BlockCache``).  A hit
  serves decoded kept points (and, once materialized, the block's
  reconstruction) with no file access.  ``pin`` exempts a window's
  blocks from eviction; ``prefetch`` warms them ahead of a query.
* **warm** — plain block bodies on disk, served via mmap page-cache
  slices (read-only opens) or coalesced preads.
* **cold** — entropy-wrapped block bodies (``store/maintenance.py``
  ``rewrite_cold``): smaller at rest, one extra unwrap per fetch, and
  byte-identical on every parse and query answer.

Demotion/promotion rewrites are append-and-republish (never in-place),
so they inherit the store's crash-atomicity; see the maintenance module
for the mechanics.  ``stats()`` surfaces the per-tier hit/byte counters
(also exported as ``store.cache.*`` / ``store.tier.*`` in ``obs``).
"""
from __future__ import annotations

import threading
from typing import List

from repro_torch.store import maintenance as _maint


class TierManager:
    """Pin/prefetch over the hot tier + demote/promote between warm and
    cold, for one store.  Every operation runs under ``lock`` — the
    owning :class:`~repro_torch.server.IngestServer` passes its ``_lock`` so
    tier rewrites serialize against live session pushes (standalone use
    gets a private lock)."""

    def __init__(self, store, lock=None):
        self._store = store
        self._lock = lock if lock is not None else threading.RLock()

    # -- hot tier ------------------------------------------------------------

    def prefetch(self, sid: str, a: int = 0, b: int = None) -> List[int]:
        """Decode the blocks overlapping ``[a, b)`` into the LRU."""
        with self._lock:
            return self._store.prefetch(sid, a, b)

    def pin(self, sid: str, a: int = 0, b: int = None) -> List[int]:
        """Prefetch + pin a window's blocks hot (evict-exempt); returns
        the pinned block indices.  Pins survive until ``unpin``."""
        with self._lock:
            bis = self._store.prefetch(sid, a, b)
            for bi in bis:
                self._store._cache.pin((sid, bi))
            return bis

    def unpin(self, sid: str, a: int = 0, b: int = None) -> None:
        with self._lock:
            entry = self._store._series[sid]
            b = entry["n"] if b is None else b
            for bi in self._store._overlapping(sid, int(a), int(b)):
                self._store._cache.unpin((sid, bi))

    # -- warm <-> cold -------------------------------------------------------

    def demote_cold(self, sid: str, *, codec: str = "auto") -> dict:
        """Entropy-wrap one series' block bodies (see ``rewrite_cold``)."""
        with self._lock:
            return _maint.rewrite_cold(self._store, sid, codec=codec)

    def promote_warm(self, sid: str) -> dict:
        """Unwrap one series' bodies back to the warm tier."""
        with self._lock:
            return _maint.promote_warm(self._store, sid)

    # -- accounting ----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return self._store.tier_stats()
