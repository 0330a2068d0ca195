"""The pre-fetch service (paper §III-B / §IV-C), threaded runtime.

One instance runs per node (per JAX host process).  The wrapped Sampler
announces fetch rounds; the service acknowledges immediately and downloads
the round's objects from the bucket *in parallel* in the background, then
bulk-inserts them into the node's capped cache ("once they are all ready,
they are cached in parallel").  The training loop never waits on the
service: on a cache miss it falls back to the bucket itself.

Faithful-to-paper behaviours:
  * requests are acknowledged instantly; fetch work is queued (the paper
    spins up a subprocess per request on a 2-vCPU VM — effective
    serialization; we use one worker thread, which also makes the runtime
    agree with the discrete-event simulator);
  * inserts happen only after the whole round is downloaded (bulk insert);
  * the naive prototype lists the bucket on every fetch round (this is the
    Class A cost the paper calls out in §III-C footnote 3) — disable with
    ``list_every_fetch=False`` to get the beyond-paper listing cache (§VI).

Beyond-paper behaviours:
  * ``streaming_insert=True`` inserts each object as it lands instead of at
    round completion, shaving the head-of-round miss window;
  * hedged GETs for straggler mitigation when running over a real threaded
    store (duplicate request after ``hedge_after_s``);
  * cooperative peer caching: hand the service a
    ``repro.distributed.PeerStore`` and every per-key GET walks the remote
    tier stack (peer tier first, bucket second — see
    ``repro.pipeline.tiers``), so fetch rounds pull cluster-resident
    samples over the inter-node network instead of issuing Class B bucket
    requests for them.  Attribution is explicit: each fetch returns a
    ``TierResult`` naming the serving tier.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor, TimeoutError as FutureTimeout
from typing import TYPE_CHECKING, Optional, Sequence

from repro_torch.core.cache import CappedCache
from repro_torch.core.clock import Clock
from repro_torch.core.listing_cache import ListingCache
from repro_torch.core.store import SampleStore, SimulatedBucketStore
from repro_torch.core.types import FetchRequest

# Late-bound module reference: repro.pipeline.tiers imports repro.core back;
# resolving attributes at call time keeps either package importable first
# (see the matching note in repro.core.dataset).
import repro_torch.pipeline.tiers as _tiers

if TYPE_CHECKING:
    from repro_torch.pipeline.tiers import ReadTier, TierResult


class PrefetchService:
    def __init__(
        self,
        store: SampleStore,
        cache: CappedCache,
        n_connections: int = 16,
        clock: Optional[Clock] = None,
        list_every_fetch: bool = True,
        listing_cache: Optional[ListingCache] = None,
        streaming_insert: bool = False,
        hedge_after_s: Optional[float] = None,
        tiers: Optional[Sequence["ReadTier"]] = None,
    ):
        self.store = store
        self.cache = cache
        self.n_connections = n_connections
        self.clock = clock or store.clock
        self.list_every_fetch = list_every_fetch
        self.listing_cache = listing_cache
        self.streaming_insert = streaming_insert
        self.hedge_after_s = hedge_after_s
        # Remote read path for per-key GETs: peer tier (when the store is a
        # PeerStore) then bucket — the same explicit stack the demand path
        # walks past its local cache tiers.
        self.tiers = _tiers.TierStack(
            list(tiers) if tiers is not None else _tiers.tiers_for_store(store)
        )
        self.hedges = 0
        self.rounds_completed = 0
        self.samples_fetched = 0
        # Round objects pulled from a peer's cache instead of the bucket
        # (populated when the tier stack contains a peer tier).
        self.peer_fetches = 0
        self._queue: "queue.Queue[Optional[FetchRequest]]" = queue.Queue()
        self._request_counter = 0
        self._idle = threading.Event()
        self._idle.set()
        self._worker = threading.Thread(target=self._run, daemon=True, name="deli-prefetch")
        self._started = False
        self._closed = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "PrefetchService":
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def close(self) -> None:
        if self._started and not self._closed:
            self._queue.put(None)
            self._worker.join(timeout=60)
        self._closed = True

    def __enter__(self) -> "PrefetchService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- API used by the Sampler wrapper ------------------------------------
    def request(self, keys: Sequence[int], stats=None, replay: bool = False) -> FetchRequest:
        """Announce a fetch round; returns immediately (paper semantics).

        ``stats`` (an ``EpochStats``) is accepted for interface symmetry
        with the deterministic ``repro.core.lockstep`` service and ignored:
        a free-running worker cannot attribute its peer pulls to an epoch
        (they are reported on ``peer_fetches`` / ``PeerStore.peer_hits``).

        ``replay=True`` marks a round re-announced by a mid-epoch resume
        (``DeliLoader``): a fully cache-resident replay is dropped here so
        it cannot re-bill the per-round Class A listing (the worker already
        filters resident keys from the GETs); partially evicted replays are
        fetched like any round.
        """
        if not self._started:
            self.start()
        if replay and all(self.cache.contains(k) for k in keys):
            self._request_counter += 1
            return FetchRequest(
                keys=(), request_id=self._request_counter, issued_at=self.clock.now()
            )
        self._request_counter += 1
        req = FetchRequest(
            keys=tuple(keys), request_id=self._request_counter, issued_at=self.clock.now()
        )
        self._idle.clear()
        self._queue.put(req)
        return req

    def drain(self, timeout: float = 120.0) -> bool:
        """Block until all queued rounds are fetched+inserted (tests only)."""
        return self._idle.wait(timeout)

    def advance_to(self, now: float) -> int:
        """No-op: a free-running worker applies completions on its own
        schedule.  Interface symmetry with ``LockstepPrefetchService`` so
        the loader can fold deterministic completions unconditionally."""
        return 0

    # -- worker --------------------------------------------------------------
    def _list_bucket(self) -> None:
        """The prototype's per-fetch listing (Class A traffic)."""
        if self.listing_cache is not None:
            self.listing_cache.list(self.store)
        else:
            self.store.list_objects()

    def _fetch_round(self, req: FetchRequest) -> None:
        keys = [k for k in req.keys if not self.cache.contains(k)]
        listing_thread: Optional[threading.Thread] = None
        if self.list_every_fetch:
            # The round's keys are already known: the naive per-round listing
            # overlaps the GETs (it is Class A accounting, not a dependency).
            listing_thread = threading.Thread(target=self._list_bucket, daemon=True)
            listing_thread.start()
        if not keys:
            if listing_thread:
                listing_thread.join()
            return
        if isinstance(self.store, SimulatedBucketStore):
            payloads = self.store.bulk_get(keys, self.n_connections)
            if self.streaming_insert:
                # Simulated time already elapsed in one block; insert order
                # still matters for FIFO eviction.
                for k, p in zip(keys, payloads):
                    self.cache.put(k, p)
            else:
                self.cache.put_many(zip(keys, payloads))
        else:
            payloads_by_key = {}

            def _get(k) -> "TierResult":
                return self.tiers.fetch(k)

            with ThreadPoolExecutor(max_workers=self.n_connections) as pool:
                futures = {k: pool.submit(_get, k) for k in keys}
                for k, fut in futures.items():
                    # Resolve the payload (hedged or plain), THEN fall through
                    # to a single insert point — a fast pre-deadline result
                    # must take the same streaming-insert path as everything
                    # else (regression: such payloads were never cached).
                    if self.hedge_after_s is not None:
                        try:
                            result = fut.result(timeout=self.hedge_after_s)
                        except FutureTimeout:
                            self.hedges += 1
                            hedge = pool.submit(_get, k)
                            result = None
                            for f in (fut, hedge):
                                try:
                                    result = f.result(timeout=self.hedge_after_s * 10)
                                    break
                                except FutureTimeout:
                                    continue
                            if result is None:
                                result = fut.result()
                    else:
                        result = fut.result()
                    if result.tier == "peer":
                        self.peer_fetches += 1
                    payloads_by_key[k] = result.payload
                    if self.streaming_insert:
                        self.cache.put(k, result.payload)
            if not self.streaming_insert:
                self.cache.put_many((k, payloads_by_key[k]) for k in keys)
        if listing_thread:
            listing_thread.join()
        self.samples_fetched += len(keys)

    def _run(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                self._idle.set()
                return
            try:
                self._fetch_round(req)
                self.rounds_completed += 1
            except Exception:
                # A failed round is not fatal: the training loop falls back
                # to the bucket for those keys (paper's miss path).  The
                # ReliableStore wrapper should make this rare.
                pass
            finally:
                if self._queue.empty():
                    self._idle.set()
