"""Dataset layer: cache-through access to a sample store.

``CachingDataset`` is the analogue of the paper's custom Dataset wrapper
(§IV-B): a ``get`` walks the node's ordered read-tier stack — local cache
(RAM tier, then spill-disk tier), optional cooperative peer tier, then the
backing bucket — and, *only when no pre-fetch service owns cache
population*, inserts bucket/peer payloads into the cache ("we choose to
not have the worker perform a cache insert in this case, as the pre-fetch
service will eventually perform this insert operation", §IV-C).

The stack is built by ``repro.pipeline.tiers`` (explicit composition,
replacing the seed's ``getattr(store, "get_with_origin")`` duck-typing);
attribution comes back as a ``TierResult`` per read, surfaced here as
``AccessResult`` with backward-compatible ``hit``/``ram_hit``/``peer_hit``
views.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import TYPE_CHECKING, Callable, Optional, Sequence, Tuple

from repro_torch.core.cache import CappedCache
from repro_torch.core.store import SampleStore

# Late-bound module reference (not a from-import): ``repro.pipeline.tiers``
# imports repro.core back, so either package must be importable first.
# Binding the module object and resolving attributes at call time keeps
# both entry orders working (``pydoc repro.pipeline`` imports the pipeline
# package before repro.core has finished initializing).
import repro_torch.pipeline.tiers as _tiers

if TYPE_CHECKING:
    from repro_torch.pipeline.tiers import ReadTier


@dataclasses.dataclass
class AccessResult:
    """One read's attribution, keyed by the tier that served it."""

    payload: bytes
    tier: str  # "ram" | "disk" | "peer" | "bucket" | ...
    class_b: int = 0
    nbytes: int = 0
    seconds: float = 0.0

    @property
    def hit(self) -> bool:
        """Local-cache hit (the paper's 'cache hit')."""
        return self.tier in _tiers.LOCAL_TIERS

    @property
    def ram_hit(self) -> bool:
        return self.tier == "ram"

    @property
    def peer_hit(self) -> bool:
        """Served from a peer node's cache — no Class B request issued."""
        return self.tier == "peer"


class CachingDataset:
    """Cache-through dataset over an ordered read-tier stack.

    The legacy ``(store, cache)`` constructor is preserved: it composes
    ``[RamTier, DiskTier] + tiers_for_store(store)`` automatically.  Pass
    ``tiers`` to substitute a custom remote stack (the local cache tiers
    are always derived from ``cache``).
    """

    def __init__(
        self,
        store: SampleStore,
        cache: Optional[CappedCache],
        insert_on_miss: bool = True,
        transform: Optional[Callable[[bytes], bytes]] = None,
        tiers: Optional[Sequence[ReadTier]] = None,
    ):
        self.store = store
        self.cache = cache
        self.insert_on_miss = insert_on_miss
        self.transform = transform
        remote = list(tiers) if tiers is not None else _tiers.tiers_for_store(store)
        self.tiers = _tiers.TierStack(_tiers.local_tiers_for_cache(cache) + remote)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, index: int) -> AccessResult:
        result = self.tiers.fetch(index)
        hit = result.tier in _tiers.LOCAL_TIERS
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        payload = result.payload
        if not hit:
            if self.cache is not None:
                self.cache.note_miss()
                if self.insert_on_miss:
                    self.cache.put(index, payload)
        if self.transform:
            payload = self.transform(payload)
        return AccessResult(
            payload,
            tier=result.tier,
            class_b=result.class_b,
            nbytes=result.nbytes,
            seconds=result.seconds,
        )

    def __getitem__(self, index: int) -> bytes:
        return self.get(index).payload

    def reset_counters(self) -> Tuple[int, int]:
        with self._lock:
            h, m = self.hits, self.misses
            self.hits = 0
            self.misses = 0
        return h, m
