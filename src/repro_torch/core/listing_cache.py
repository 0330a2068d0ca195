"""Listing cache (beyond-paper cost optimization, paper §VI).

The DELI prototype lists the entire bucket on *every* fetch round, costing
``ceil(m/p)`` Class A requests per round (Eq. 5's multiplier).  The paper's
discussion section proposes caching the listing per node — one listing per
node per session — which collapses the Class A term of Eq. 5 back to Eq. 4.

``ttl_s`` optionally re-validates the listing (online-learning buckets where
objects arrive continuously); ``ttl_s=None`` lists exactly once.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from repro_torch.core.clock import Clock, RealClock
from repro_torch.core.store import SampleStore


class ListingCache:
    def __init__(self, ttl_s: Optional[float] = None, clock: Optional[Clock] = None):
        self.ttl_s = ttl_s
        self.clock = clock or RealClock()
        self._lock = threading.Lock()
        self._listing: Optional[List[int]] = None
        self._listed_at: float = float("-inf")
        self.lists_issued = 0
        self.lists_served_from_cache = 0

    def list(self, store: SampleStore) -> List[int]:
        with self._lock:
            now = self.clock.now()
            fresh = self._listing is not None and (
                self.ttl_s is None or now - self._listed_at < self.ttl_s
            )
            if fresh:
                self.lists_served_from_cache += 1
                assert self._listing is not None
                return list(self._listing)
        listing = store.list_objects()
        with self._lock:
            self._listing = listing
            self._listed_at = self.clock.now()
            self.lists_issued += 1
        return list(listing)

    def invalidate(self) -> None:
        with self._lock:
            self._listing = None
