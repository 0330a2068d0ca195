"""The composable read-tier stack: the paper's layered data plane, explicit.

The paper's §IV design is a *layered* read path — node-local cache, peer
caches (PR 1's cooperative tier), object-store bucket — but until this
module the layers were implicit: every component duck-typed its neighbours
(``getattr(store, "get_with_origin")``, ``getattr(store, "clock")``) and
hit attribution was a pile of ad-hoc booleans.  Hoard (Pinto et al.) showed
tiered caches want an explicit tier interface; this module provides it:

  * ``TierResult`` — one read's full attribution: payload, which tier
    served it, Class B requests billed, bytes moved, seconds spent.
  * ``ReadTier``   — the protocol: ``lookup(index) -> Optional[TierResult]``
    (None = this tier does not hold the sample; the next tier is consulted).
    A tier that misses may still charge time (e.g. a failed peer probe pays
    the lookup RTT on the tier's clock).
  * ``RamTier`` / ``DiskTier``  — the two halves of a ``CappedCache``
    (in-memory entries vs spill files), reported separately so the explicit
    RAM-tier measurement from the seed (``EpochStats.ram_hits``) survives.
  * ``PeerTier``   — PR 1's cooperative peer-cache tier over a ``PeerStore``.
  * ``BucketTier`` — the authoritative source (any ``SampleStore``); always
    hits or raises ``StoreError``.
  * ``TierStack``  — an ordered composition; ``fetch`` walks tiers until one
    serves the read.

``tiers_for_store`` maps a store object onto its remote tiers (peer tier +
wrapped bucket for a ``PeerStore``, plain bucket otherwise) — one explicit
``isinstance``, replacing scattered ``getattr`` probes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, runtime_checkable

from repro_torch.core.cache import CappedCache
from repro_torch.core.store import SampleStore, StoreError

# Single source of truth lives in repro.core.types (the dependency root,
# where EpochStats derives hits/misses from it); re-exported here as part
# of the tier API: tiers whose hits are *local-cache* hits — everything
# else (peer, bucket) is a miss of the local cache even when it avoids the
# bucket.
from repro_torch.core.types import LOCAL_TIERS  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class TierResult:
    """Full attribution for one served read."""

    payload: bytes
    tier: str  # "ram" | "disk" | "peer" | "bucket" | ...
    class_b: int = 0  # Class B GETs billed serving this read
    nbytes: int = 0  # payload bytes moved across the tier boundary
    seconds: float = 0.0  # time spent inside the tier (virtual or wall)

    @property
    def local_hit(self) -> bool:
        return self.tier in LOCAL_TIERS


@runtime_checkable
class ReadTier(Protocol):
    """One layer of the data plane's read path."""

    name: str

    def lookup(self, index: int) -> Optional[TierResult]:
        """Serve ``index`` from this tier, or return None (not resident).

        A miss may still charge time to the tier's clock (failed probes);
        it must never raise for mere non-residency.
        """
        ...


class RamTier:
    """In-memory half of a ``CappedCache`` (the paper's WiredTiger RAM set)."""

    name = "ram"

    def __init__(self, cache: CappedCache):
        self.cache = cache

    def lookup(self, index: int) -> Optional[TierResult]:
        payload = self.cache.probe_ram(index)
        if payload is None:
            return None
        return TierResult(payload, self.name, nbytes=len(payload))


class DiskTier:
    """Spill-file half of a ``CappedCache`` (entries beyond ``ram_items``)."""

    name = "disk"

    def __init__(self, cache: CappedCache):
        self.cache = cache

    def lookup(self, index: int) -> Optional[TierResult]:
        payload = self.cache.probe_disk(index)
        if payload is None:
            return None
        return TierResult(payload, self.name, nbytes=len(payload))


class PeerTier:
    """Cooperative peer-cache tier: another node's cache over the network.

    Wraps a ``repro.distributed.PeerStore`` (constructed for it by
    ``tiers_for_store``), whose ``peer_lookup`` owns the registry probe,
    the modelled transfer time and the peer-traffic accounting — so
    ``PeerStore.peer_hits`` keeps counting physical peer reads no matter
    which path (demand or pre-fetch) performed them.
    """

    name = "peer"

    def __init__(self, store: "SampleStore"):
        # A PeerStore; typed loosely to keep this module import-light.
        self.store = store

    def lookup(self, index: int) -> Optional[TierResult]:
        return self.store.peer_lookup(index)


class BucketTier:
    """The authoritative source: any ``SampleStore`` (always serves)."""

    name = "bucket"

    def __init__(self, store: SampleStore):
        self.store = store

    def lookup(self, index: int) -> Optional[TierResult]:
        t0 = self.store.clock.now()
        payload = self.store.get(index)
        dt = self.store.clock.now() - t0
        return TierResult(
            payload, self.name, class_b=1, nbytes=len(payload), seconds=dt
        )


class DiskSourceTier:
    """The paper's local-disk *source* baseline (not the cache spill tier).

    Wraps a ``FileSystemStore`` holding the materialized dataset.  Reads
    are attributed to tier ``"disk-source"`` — deliberately outside
    ``LOCAL_TIERS``, because the disk baseline has no cache at all: every
    access counts as a miss (miss rate 1.0), matching the simulator's
    disk-source accounting.  No Class B request is billed (local disk is
    not object storage)."""

    name = "disk-source"

    def __init__(self, store: SampleStore):
        self.store = store

    def lookup(self, index: int) -> Optional[TierResult]:
        t0 = self.store.clock.now()
        payload = self.store.get(index)
        dt = self.store.clock.now() - t0
        return TierResult(
            payload, self.name, class_b=0, nbytes=len(payload), seconds=dt
        )


class TierStack:
    """Ordered composition of read tiers — the node's whole read path."""

    def __init__(self, tiers: Sequence[ReadTier]):
        if not tiers:
            raise ValueError("a TierStack needs at least one tier")
        self.tiers: List[ReadTier] = list(tiers)

    def names(self) -> List[str]:
        return [t.name for t in self.tiers]

    def lookup(self, index: int) -> Optional[TierResult]:
        for tier in self.tiers:
            result = tier.lookup(index)
            if result is not None:
                return result
        return None

    def fetch(self, index: int) -> TierResult:
        """Walk the stack; the last tier is expected to be authoritative."""
        result = self.lookup(index)
        if result is None:
            raise StoreError(f"no tier in {self.names()} holds object {index}")
        return result


def tiers_for_store(store: SampleStore) -> List[ReadTier]:
    """The *remote* tiers behind a store object (everything past the local
    cache): ``[PeerTier, BucketTier]`` for a ``PeerStore``, else
    ``[BucketTier]``.  This one explicit dispatch replaces the
    ``getattr(store, "get_with_origin")`` duck-typing the seed used."""
    from repro_torch.distributed.peer_cache import PeerStore  # leaf module; no cycle

    if isinstance(store, PeerStore):
        return [PeerTier(store), BucketTier(store.inner)]
    return [BucketTier(store)]


def local_tiers_for_cache(cache: Optional[CappedCache]) -> List[ReadTier]:
    """The node-local tiers over a cache (empty stack for cache-less modes)."""
    if cache is None:
        return []
    return [RamTier(cache), DiskTier(cache)]
