"""Cooperative peer-cache tier: nodes serve each other's cache misses.

The paper's DELI design caches bucket data node-locally, so every node pays
full Class B traffic for samples its *peers* already hold.  Hoard (Pinto et
al., 2018) showed a distributed cache tier across training nodes recovers
most of that bandwidth; Clairvoyant Prefetching / NoPFS (Dryden et al.,
2021) multiplies the benefit with locality-aware sample assignment.  This
module adds that tier to both execution paths:

  * ``PeerCacheRegistry`` — the cluster-wide directory: which node's
    ``CappedCache`` to ask for a given sample index.  In this repo the
    "network" is a ``NetworkModel`` (timing only); the registry is the
    integration point for a real RPC transport (gRPC sidecar, NCCL
    broadcast, ...) later.  It also maintains *resident-copy counts* per
    sample; with ``replication_aware=True`` member caches decline to evict
    the last cluster-resident copy of a sample (Hoard keeps one), so peers
    keep serving it instead of someone re-paying a bucket GET.
  * ``PeerStore`` — a ``SampleStore`` whose ``peer_lookup`` serves a read
    from a peer's cache over the modelled inter-node network, returning the
    explicit per-tier attribution (``repro.pipeline.tiers.TierResult``); a
    miss charges the lookup RTT and returns None so the next tier (the
    wrapped bucket) takes over.  A peer hit costs an RTT + payload/bandwidth
    instead of a bucket GET (no Class B request billed).

Consistency note: caches are keyed by (session, index) and entries are
immutable once inserted (payloads are content-addressed by dataset index),
so serving a peer's copy can never return stale data — eviction races
simply degrade to a bucket fallback.

Visibility note (ISSUE 3): what a ``lookup`` *observes* depends on the
cluster schedule.  Under the event-interleaved scheduler (the default for
both execution paths) a probe sees every peer's **mid-epoch** cache state —
same-epoch fills and evictions alike — because all nodes advance through
one virtual-time event queue and fold their pre-fetch completions before
any node is stepped.  The legacy sequential schedule
(``interleaved=False``) froze peers at epoch boundaries, which overstated
this tier for capped caches; ``benchmarks/fig10_peer_cache.py`` reports
the delta.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from repro_torch.core.bandwidth import DEFAULT_NETWORK, NetworkModel
from repro_torch.core.cache import CappedCache
from repro_torch.core.clock import Clock
from repro_torch.core.store import SampleStore
from repro_torch.pipeline.tiers import TierResult


class PeerCacheRegistry:
    """Directory of every node's cache, shared by all ``PeerStore``s.

    Thread-safe: the threaded runtime registers/looks up concurrently from
    per-node prefetch workers and training loops.  ``lookup`` returns the
    id of a node (other than the requester) whose cache currently holds the
    index — preferring the lowest node id for determinism — or ``None``.

    ``replication_aware=True`` (Hoard-style, beyond-paper) wires an
    eviction guard into every registered cache: the FIFO victim search
    skips entries whose cluster-wide resident-copy count is 1, so the last
    copy of a sample survives as long as anything else can be evicted
    instead.  Copy counts are maintained via the caches' residency
    listeners (updated under each cache's own lock, then this registry's
    lock; the registry never takes a cache lock while holding its own, so
    the lock order is acyclic).
    """

    def __init__(self, replication_aware: bool = False) -> None:
        self.replication_aware = replication_aware
        self._caches: Dict[int, CappedCache] = {}
        self._copies: Dict[int, int] = {}  # index -> cluster-resident copies
        self._lock = threading.Lock()
        self.lookups = 0
        self.peer_hits = 0

    # -- residency bookkeeping ----------------------------------------------
    def _note_insert(self, index: int) -> None:
        with self._lock:
            self._copies[index] = self._copies.get(index, 0) + 1

    def _note_evict(self, index: int) -> None:
        with self._lock:
            left = self._copies.get(index, 0) - 1
            if left > 0:
                self._copies[index] = left
            else:
                self._copies.pop(index, None)

    def _guard_last_copy(self, index: int) -> bool:
        """Eviction guard: True = protected (last cluster-resident copy).

        Called once per probed entry with the probing cache's lock held, so
        this reads ``_copies`` WITHOUT the registry lock: a single
        ``dict.get`` is atomic under the GIL, and the guard is advisory —
        a racing insert/evict at worst yields one momentarily stale
        protection decision, never a wrong eviction.  (Caches report how
        often protection redirected an eviction via
        ``CacheStats.guard_skips``.)
        """
        return self._copies.get(index, 0) <= 1

    def resident_copies(self, index: int) -> int:
        """How many member caches currently hold ``index``."""
        with self._lock:
            return self._copies.get(index, 0)

    def register(self, node: int, cache: CappedCache) -> None:
        with self._lock:
            if node in self._caches and self._caches[node] is not cache:
                raise ValueError(f"node {node} already registered")
            already = self._caches.get(node) is cache
            self._caches[node] = cache
        if already:
            return
        # Fold pre-registration residents into the copy counts.  Read the
        # key set without holding the registry lock (lock-order discipline).
        resident = cache.keys()
        with self._lock:
            for idx in resident:
                self._copies[idx] = self._copies.get(idx, 0) + 1
        cache.set_residency_listener(self._note_insert, self._note_evict)
        if self.replication_aware:
            cache.eviction_guard = self._guard_last_copy

    def nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._caches)

    def cache_of(self, node: int) -> CappedCache:
        with self._lock:
            return self._caches[node]

    def lookup(self, index: int, requester: Optional[int] = None) -> Optional[int]:
        """Find a peer (not the requester) whose cache holds ``index``.

        A positive lookup is only a *candidate*: the holder may evict the
        entry before the payload read.  Callers confirm the hit with
        :meth:`record_hit` once the payload is actually in hand, so
        ``peer_hits`` never overcounts the eviction race.
        """
        with self._lock:
            candidates = sorted(self._caches)
            self.lookups += 1
        for node in candidates:
            if node == requester:
                continue
            if self._caches[node].contains(index):
                return node
        return None

    def record_hit(self) -> None:
        """Count one confirmed peer-served read (payload obtained)."""
        with self._lock:
            self.peer_hits += 1

    def cache_views(self) -> List[List[int]]:
        """Per-node cached index sets, ordered by node id (the all-gather a
        real deployment would perform for ``LocalityAwareSampler``)."""
        with self._lock:
            items = sorted(self._caches.items())
        return [cache.keys() for _, cache in items]


class PeerStore(SampleStore):
    """Store wrapper: peers' caches first, wrapped bucket store second.

    ``peer_lookup`` is the ``PeerTier`` entry point (the local cache itself
    sits in front of this store, inside ``CachingDataset``/
    ``NodeSimulator``):

      1. registry lookup -> peer cache read + modelled network transfer
         (no Class B request, no bucket latency) -> ``TierResult``;
      2. None on a miss (after charging the lookup RTT), so the stack falls
         through to the wrapped bucket — the usual Class B miss path.

    The eviction race (peer listed as holder, entry gone by the time we
    read) degrades to the fallback, never to an error.
    """

    def __init__(
        self,
        inner: SampleStore,
        registry: PeerCacheRegistry,
        node: int,
        network: NetworkModel = DEFAULT_NETWORK,
        clock: Optional[Clock] = None,
        charge_lookup_on_miss: bool = True,
    ):
        super().__init__()
        self.inner = inner
        self.registry = registry
        self.node = node
        self.network = network
        self.clock = clock or inner.clock
        self.charge_lookup_on_miss = charge_lookup_on_miss
        self.peer_hits = 0
        self.peer_bytes = 0
        self.peer_seconds = 0.0
        self._peer_lock = threading.Lock()

    def peer_lookup(self, index: int) -> Optional[TierResult]:
        """Serve ``index`` from a peer's cache; None = not cluster-resident.

        The returned ``TierResult`` is the per-call attribution (tier
        "peer", zero Class B), so callers sharing this store concurrently
        (prefetch workers + the training loop) can never misattribute a
        read.
        """
        holder = self.registry.lookup(index, requester=self.node)
        if holder is not None:
            # peek(): don't pollute the holder's own hit/miss accounting.
            payload = self.registry.cache_of(holder).peek(index)
            if payload is not None:
                dt = self.network.transfer_seconds(len(payload))
                self.clock.sleep(dt)
                with self._peer_lock:
                    self.peer_hits += 1
                    self.peer_bytes += len(payload)
                    self.peer_seconds += dt
                self.registry.record_hit()
                return TierResult(
                    payload, "peer", class_b=0, nbytes=len(payload), seconds=dt
                )
        if self.charge_lookup_on_miss:
            self.clock.sleep(self.network.lookup_seconds())
        return None

    def get(self, index: int, **kw) -> bytes:
        result = self.peer_lookup(index)
        if result is not None:
            return result.payload
        return self.inner.get(index, **kw)

    def get_with_origin(self, index: int, **kw) -> "tuple[bytes, bool]":
        """Legacy shim: GET returning ``(payload, served_by_peer)``.

        Pre-tier callers used this per-call flag for attribution; new code
        reads ``TierResult.tier`` from ``peer_lookup`` / the tier stack.
        """
        result = self.peer_lookup(index)
        if result is not None:
            return result.payload, True
        return self.inner.get(index, **kw), False

    def size_of(self, index: int) -> int:
        return self.inner.size_of(index)

    def list_objects(self) -> List[int]:
        return self.inner.list_objects()

    @property
    def stats(self):  # type: ignore[override]
        # Class A/B accounting lives where the requests are billed: the
        # wrapped bucket store.  Peer traffic is tracked separately above.
        return self.inner.stats

    @stats.setter
    def stats(self, v) -> None:
        if hasattr(self, "inner"):
            self.inner.stats = v
        else:  # abc __init__ assigns before inner exists
            self.__dict__["_pre_init_stats"] = v
