"""Capped FIFO sample cache — the explicit analogue of the paper's MongoDB
capped collection (§IV-B).

Semantics copied from the paper:

  * entries are keyed by (session id, dataset index) — the "multi-key index";
  * capacity-limited; on overflow the *oldest inserted* entries are evicted
    (FIFO, exactly a capped collection);
  * lookups by key; inserts are idempotent (re-inserting refreshes nothing —
    FIFO order is insertion order, like capped collections).

Beyond the paper we make MongoDB's hidden RAM tier explicit: a ``ram_items``
budget worth of the most recently inserted entries stays in memory; the
remainder lives in an optional on-disk spill directory.  The paper observed
its 50/50 speedups partly came from WiredTiger holding the working set in
RAM (§V-D/§VI); with an explicit tier we can *measure* that effect
(``EpochStats.ram_hits``) instead of inheriting it silently.

Capacity may be expressed in items (as the paper's experiments do: cache
sizes are sample counts) or bytes (production: disks are sized in bytes).

Eviction is a pluggable **policy object** (ISSUE 5): the capped-collection
FIFO order above is ``FifoEviction``, the default; the oracle subsystem
(``repro.oracle``) provides ``BeladyEviction`` — farthest-future-use, the
provably optimal offline policy — built on the clairvoyant access order a
seeded sampler exposes.  The replication-aware ``eviction_guard`` composes
with *any* policy: guarded entries are skipped and capacity always wins
when everything is guarded.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.types import SampleKey


class EvictionPolicy:
    """Strategy that picks which cached entry to evict.

    ``select_victim`` receives the cache's entries **in FIFO (insertion)
    order** plus the optional replication-aware guard, and returns
    ``(victim_key, guard_skips)`` — the entry to evict and how many guarded
    entries the guard *actually redirected away from* (the ``guard_skips``
    accounting ``CacheStats`` has always kept).  Policies must be
    deterministic pure functions of their inputs: both execution
    projections evaluate them against identical cache states, which is what
    keeps policy-driven eviction inside the exact-parity domain
    (docs/PARITY.md).  Called under the cache lock — must not call back
    into the cache.
    """

    name = "policy"

    def select_victim(
        self,
        entries: Iterable[SampleKey],
        guard: Optional[Callable[[int], bool]],
    ) -> Tuple[SampleKey, int]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class FifoEviction(EvictionPolicy):
    """The paper's capped-collection order: evict the oldest insert.

    Byte-for-byte the pre-ISSUE-5 ``CappedCache`` behaviour, as a policy
    object: oldest *unguarded* entry first (early-stopping scan, so the
    typical probe count is 1); plain FIFO fallback — with no skips counted
    — when every entry is guarded, so capacity bounds always hold.
    """

    name = "fifo"

    def select_victim(
        self,
        entries: Iterable[SampleKey],
        guard: Optional[Callable[[int], bool]],
    ) -> Tuple[SampleKey, int]:
        first: Optional[SampleKey] = None
        skipped = 0
        for key in entries:
            if first is None:
                first = key
            if guard is None or not guard(key.index):
                return key, skipped
            skipped += 1
        assert first is not None, "select_victim called on an empty cache"
        return first, 0  # everything guarded: capacity wins, no redirect


class CacheStats:
    __slots__ = (
        "hits",
        "misses",
        "inserts",
        "evictions",
        "ram_hits",
        "disk_hits",
        "guard_skips",
    )

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.ram_hits = 0
        self.disk_hits = 0
        # Entries the eviction guard protected during evictions that DID
        # find another victim (how often Hoard-style last-copy protection
        # actually changed an outcome; all-protected FIFO fallbacks add 0).
        self.guard_skips = 0

    def as_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.__slots__}


class CappedCache:
    """Thread-safe capped FIFO cache with an explicit RAM tier.

    ``max_items``/``max_bytes``: either or both; ``None`` = unlimited (the
    paper's "unlimited cache" baseline).  ``ram_items`` bounds the in-memory
    tier; entries beyond it are transparently spilled to ``spill_dir`` (if
    given) or kept in RAM anyway (pure-RAM mode, used by the simulator where
    payloads are sizes, not bytes).  ``eviction_policy`` selects victims
    (default: ``FifoEviction``, the capped-collection order).
    ``spill_order`` selects *which* RAM payloads spill when ``ram_items``
    overflows (default ``None`` = oldest inserts, the historical FIFO slice
    pinned byte-for-byte; ``repro.oracle.OracleSpillOrder`` spills
    farthest-future-use keys first).
    """

    def __init__(
        self,
        max_items: Optional[int] = None,
        max_bytes: Optional[int] = None,
        ram_items: Optional[int] = None,
        spill_dir: Optional[str] = None,
        session: str = "default",
        eviction_policy: Optional[EvictionPolicy] = None,
        spill_order=None,
    ):
        if max_items is not None and max_items <= 0:
            raise ValueError("max_items must be positive or None")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive or None")
        self.max_items = max_items
        self.max_bytes = max_bytes
        self.ram_items = ram_items
        self.spill_dir = spill_dir
        self.session = session
        self.eviction_policy = eviction_policy or FifoEviction()
        self.spill_order = spill_order
        self.stats = CacheStats()
        # Replication-aware eviction (Hoard-style): a guard saying "this
        # index must not be evicted" (e.g. it is the last cluster-resident
        # copy).  Guarded entries are skipped in FIFO order; if *every*
        # entry is guarded the plain FIFO victim is evicted anyway, so
        # capacity bounds always hold.
        self.eviction_guard: Optional[Callable[[int], bool]] = None
        # Residency listeners (the peer-cache registry's copy counter).
        self._on_insert: Optional[Callable[[int], None]] = None
        self._on_evict: Optional[Callable[[int], None]] = None
        # Flight-recorder listeners (ISSUE 10): a second, dedicated slot.
        # The residency slot above is contended (peer-cache registry, the
        # vector engine's residency bitmask) and observation must never
        # displace it.  Observe-only: fired after all state changes.
        self._trace_insert: Optional[Callable[[int], None]] = None
        self._trace_evict: Optional[Callable[[int], None]] = None
        self._lock = threading.RLock()
        # FIFO order: key -> payload (bytes) | None (spilled to disk).
        self._entries: "collections.OrderedDict[SampleKey, Optional[bytes]]" = (
            collections.OrderedDict()
        )
        self._sizes: Dict[SampleKey, int] = {}
        self._total_bytes = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    # -- helpers -----------------------------------------------------------
    def _key(self, index: int) -> SampleKey:
        return SampleKey(index=index, session=self.session)

    def _spill_path(self, key: SampleKey) -> str:
        assert self.spill_dir is not None
        return os.path.join(self.spill_dir, f"{key.session}-{key.index}.bin")

    def _evict_one_locked(self) -> None:
        # The policy picks the victim (FIFO by default, farthest-future-use
        # under ``repro.oracle.BeladyEviction``); the guard semantics live
        # in the policy too, so ``guard_skips`` keeps counting protections
        # that actually redirected an eviction.
        victim, skipped = self.eviction_policy.select_victim(
            self._entries, self.eviction_guard
        )
        self.stats.guard_skips += skipped
        payload = self._entries.pop(victim)
        self._total_bytes -= self._sizes.pop(victim)
        if payload is None and self.spill_dir:
            try:
                os.remove(self._spill_path(victim))
            except FileNotFoundError:
                pass
        self.stats.evictions += 1
        if self._on_evict is not None:
            self._on_evict(victim.index)
        if self._trace_evict is not None:
            self._trace_evict(victim.index)

    def _over_capacity_locked(self) -> bool:
        if self.max_items is not None and len(self._entries) > self.max_items:
            return True
        if self.max_bytes is not None and self._total_bytes > self.max_bytes:
            return True
        return False

    def _maybe_spill_locked(self) -> None:
        """Keep only the newest ``ram_items`` payloads in RAM."""
        if self.ram_items is None or self.spill_dir is None:
            return
        in_ram = [k for k, v in self._entries.items() if v is not None]
        excess = len(in_ram) - self.ram_items
        if excess <= 0:
            return
        to_spill = (
            in_ram[:excess]
            if self.spill_order is None
            else self.spill_order.select(in_ram, excess)
        )
        for key in to_spill:
            payload = self._entries[key]
            assert payload is not None
            with open(self._spill_path(key), "wb") as f:
                f.write(payload)
            self._entries[key] = None

    # -- public API --------------------------------------------------------
    def put(self, index: int, payload: bytes) -> bool:
        """Insert; returns False if the key was already present (idempotent)."""
        key = self._key(index)
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = payload
            self._sizes[key] = len(payload)
            self._total_bytes += len(payload)
            self.stats.inserts += 1
            if self._on_insert is not None:
                self._on_insert(index)
            if self._trace_insert is not None:
                self._trace_insert(index)
            while self._over_capacity_locked():
                self._evict_one_locked()
            self._maybe_spill_locked()
            return True

    def put_many(self, items: Iterable[Tuple[int, bytes]]) -> int:
        """Bulk insert (the pre-fetch service's 'cached in parallel' step)."""
        n = 0
        for index, payload in items:
            n += int(self.put(index, payload))
        return n

    def get(self, index: int) -> Optional[bytes]:
        """Lookup; None on miss. Tracks which tier served the hit."""
        return self.get_with_tier(index)[0]

    def get_with_tier(self, index: int) -> Tuple[Optional[bytes], Optional[str]]:
        """Lookup returning ``(payload, tier)``, tier in {"ram", "disk", None}.

        The tier is reported per-call (not via a stats-counter diff) so
        concurrent readers — the peer-cache tier reads other nodes' caches —
        can attribute their own hits correctly.
        """
        key = self._key(index)
        with self._lock:
            if key not in self._entries:
                self.stats.misses += 1
                return None, None
            payload = self._entries[key]
            self.stats.hits += 1
            if payload is not None:
                self.stats.ram_hits += 1
                return payload, "ram"
            self.stats.disk_hits += 1
        # Disk-tier read outside the lock (payload immutable once spilled).
        # Race: a concurrent insert may evict this entry and delete its spill
        # file between the lock release and the open(); re-treat as a miss.
        try:
            with open(self._spill_path(key), "rb") as f:
                return f.read(), "disk"
        except FileNotFoundError:
            with self._lock:
                self.stats.hits -= 1
                self.stats.disk_hits -= 1
                self.stats.misses += 1
            return None, None

    # -- tier-granular probes (repro.pipeline.tiers) -----------------------
    def probe_ram(self, index: int) -> Optional[bytes]:
        """RAM-tier lookup: hit accounting only on a hit, no miss counted.

        ``RamTier``/``DiskTier``/``note_miss`` together reproduce exactly
        the accounting ``get_with_tier`` performs in one call, but let the
        tier stack interleave other tiers between the probes.
        """
        key = self._key(index)
        with self._lock:
            payload = self._entries.get(key)
            if payload is None:  # absent, or spilled to the disk tier
                return None
            self.stats.hits += 1
            self.stats.ram_hits += 1
            return payload

    def probe_disk(self, index: int) -> Optional[bytes]:
        """Disk-(spill-)tier lookup; None when absent or RAM-resident."""
        key = self._key(index)
        with self._lock:
            if key not in self._entries or self._entries[key] is not None:
                return None
            self.stats.hits += 1
            self.stats.disk_hits += 1
        # Spill read outside the lock (same race handling as get_with_tier):
        # a concurrent eviction deleting the file re-treats this as a miss.
        try:
            with open(self._spill_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            with self._lock:
                self.stats.hits -= 1
                self.stats.disk_hits -= 1
            return None

    def note_miss(self) -> None:
        """Count one full-cache miss (both tier probes came back empty)."""
        with self._lock:
            self.stats.misses += 1

    def set_residency_listener(
        self,
        on_insert: Optional[Callable[[int], None]],
        on_evict: Optional[Callable[[int], None]],
    ) -> None:
        """Install insert/evict callbacks (fired under the cache lock; the
        peer-cache registry uses them to maintain cluster copy counts).
        Callbacks must not call back into this cache."""
        with self._lock:
            self._on_insert = on_insert
            self._on_evict = on_evict

    def set_trace_listener(
        self,
        on_insert: Optional[Callable[[int], None]],
        on_evict: Optional[Callable[[int], None]],
    ) -> None:
        """Install the flight recorder's insert/evict observers (ISSUE 10).

        A dedicated slot so tracing composes with — never displaces — the
        residency listener.  Installed by the *host* projection wiring
        (``repro.core.simulator`` / ``repro.pipeline.spec``), pointed at a
        ``repro.obs.events.CacheTracer``; rule PL006 keeps ``repro.obs``
        itself from mutating cache state.  Fired under the cache lock,
        after all state changes; callbacks must not call back into this
        cache."""
        with self._lock:
            self._trace_insert = on_insert
            self._trace_evict = on_evict

    def peek(self, index: int) -> Optional[bytes]:
        """Read a payload WITHOUT touching stats (or FIFO state).

        Used by the peer-cache tier when serving another node's miss, so a
        holder's hit/miss counters keep describing its *own* workload
        rather than folding in cross-node traffic.  Returns None on a
        miss or when the spill file lost an eviction race.
        """
        key = self._key(index)
        with self._lock:
            if key not in self._entries:
                return None
            payload = self._entries[key]
        if payload is not None:
            return payload
        try:
            with open(self._spill_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def contains(self, index: int) -> bool:
        with self._lock:
            return self._key(index) in self._entries

    def __contains__(self, index: int) -> bool:
        return self.contains(index)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def keys(self) -> List[int]:
        with self._lock:
            return [k.index for k in self._entries]

    def clear(self) -> None:
        with self._lock:
            while self._entries:
                self._evict_one_locked()
