"""Lock-step pre-fetch scheduling: one deterministic service, two hosts.

The paper's pre-fetch service is asynchronous by design — the training loop
never waits on it — which historically split this repo's two execution
paths: the discrete-event simulator modelled the service with virtual-time
event math (``_issue_round``/``_apply_completed_inserts``), while the
threaded runtime ran a real worker thread whose completion times depend on
OS scheduling.  Exact sim/runtime parity was therefore *defined away* for
prefetch-enabled specs (``pipeline.parity`` refused them).

Clairvoyant Prefetching (Dryden et al.) makes the case that reproducible
I/O claims need *schedule-aware, deterministic* prefetch ordering.  This
module is that scheduler: ``LockstepPrefetchService`` holds the one
canonical implementation of the service's event semantics —

  * a fetch round issued at virtual time ``t`` starts at
    ``max(t, free_at)`` (one service worker, paper §IV-C: a subprocess per
    request on a 2-vCPU VM is effectively serialized);
  * round duration is ``max(listing, bulk_get(bucket_keys) + peer_time)``
    from the calibrated models — the per-round listing is pure Class A
    accounting traffic that overlaps the parallel GETs;
  * keys a peer already holds are pulled over the modelled inter-node
    network (no Class B request billed) — the probe sequence
    (registry lookup -> holder peek -> record_hit) is the same one the
    demand path performs;
  * under cluster placement (``prefetch_policy="cluster-oracle"``,
    ``repro.oracle.placement``) the round partition gains an ownership
    rule: keys this rank does not own are *never* bucket-fetched here —
    if no peer holds one yet (the owner's fetch is still in flight) it is
    **deferred** and retried at the next round, by which time it is
    normally peer-resident.  With no placement installed the partition is
    byte-identical to the historical peer/bucket split;
  * completions are *events*: inserts are folded into the cache only when
    ``advance_to(now)`` observes virtual time at/past the round's
    completion — the well-defined barriers are each sample access (the
    owner folds before its cache lookup) and, under the event-interleaved
    cluster scheduler, every scheduler step (peers fold before any node is
    stepped, so mid-epoch cache state is consistently visible).

Both projections instantiate this class: ``NodeSimulator`` drives it with
sentinel payloads, the lock-step ``RuntimeCluster`` with real payload bytes
(``payload_for``).  Because the timing arithmetic, the key partitioning,
the billing and the insert order are literally the same code, per-tier hit
counts and Class A/B totals agree *exactly* — no tolerances anywhere (see
docs/PARITY.md).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, Callable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.bandwidth import BucketModel, NetworkModel
from repro_torch.core.cache import CappedCache
from repro_torch.core.clock import Clock
from repro_torch.core.types import EpochStats, StoreStats
from repro_torch.engine.kernels import DemandKernel
from repro_torch.obs.events import CLUSTER_NODE, TraceRecorder, trace_demand, trace_emit

if TYPE_CHECKING:  # deferred for the same reason as in core.simulator:
    # repro.distributed imports repro.core back.
    from repro_torch.distributed.peer_cache import PeerCacheRegistry

#: Simulator payloads are placeholders; experiments count items, not bytes.
SENTINEL = b"\x00"

#: Stepper signals: what one scheduler event did to the node's epoch.
#: ``STEP_DONE`` is falsy on purpose — legacy ``while node.step():`` loops
#: keep working; ``STEP_BATCH_END`` marks "this event completed a gradient
#: batch (compute included)", the parking point of the per-batch allreduce
#: barrier (``sync="batch"``).
STEP_DONE = 0
STEP_CONTINUE = 1
STEP_BATCH_END = 2


def drive_interleaved_epoch(
    n_nodes: int,
    now: Callable[[int], float],
    fold_all: Callable[[float], None],
    step: Callable[[int], int],
    barrier: Callable[[float], None],
    *,
    sync: str = "epoch",
    batch_barrier: Optional[Callable[[float, Tuple[int, ...]], None]] = None,
    backup_workers: int = 0,
    staleness_bound: int = 0,
    trace: Optional[TraceRecorder] = None,
) -> None:
    """THE event-interleaved cluster schedule for one epoch — a single
    implementation shared verbatim by the simulator and the lock-step
    runtime (``pipeline.spec.RuntimeCluster``), so the schedule can never
    drift between the two projections:

      * event heap keyed by ``(now(rank), rank)`` — the globally-earliest
        event always executes next, ties broken by rank (one event is a
        whole sample access at ``granularity="step"``, or one virtual-time
        component of it at ``granularity="substep"``);
      * before every step, ``fold_all(t)`` applies every node's prefetch
        completions with time <= t (safe: the heap invariant guarantees
        every other node's own next event is at >= t);
      * ``step(rank)`` processes one event and returns a signal:
        ``STEP_DONE`` = epoch exhausted for that node (it leaves the heap),
        ``STEP_BATCH_END`` = the event completed a gradient batch,
        ``STEP_CONTINUE`` = anything else;
      * ``sync="batch"`` (the data-parallel SGD schedule, ISSUE 4): a node
        reaching ``STEP_BATCH_END`` *parks* until every still-running node
        reaches its own batch boundary, then
        ``batch_barrier(max(now(parked)), parked_ranks)`` models the
        allreduce — the projection accounts each parked node's wait and
        jumps its clock to the barrier time — and all parked nodes
        re-enter the heap together.  Within one barrier interval every node
        advances exactly one batch: BSP at gradient granularity.  A node
        whose epoch ends (unequal shard) simply stops participating, like
        a DDP join; its peers' remaining barriers exclude it.
      * **straggler mitigation** (ISSUE 8) relaxes the parking discipline:

          - ``backup_workers=k`` releases a barrier as soon as
            ``active - k`` running ranks have parked — the slowest ``k``
            ranks at that round skip the barrier entirely (their partial
            gradient is dropped; their sample reads remain accounted) and
            simply keep stepping until they are no longer behind;
          - ``staleness_bound=s`` lets a rank run up to ``s`` batches
            ahead of the last released barrier before parking (stale-
            synchronous parallel); ``s=0`` parks at every batch boundary.

        Both reduce to the plain BSP schedule event-for-event at their
        zero settings.  A barrier released while stragglers still hold
        heap events folds only up to ``min(t_bar, earliest heap event)``
        — folding past a still-running node's next event would break the
        fold-safety invariant above.
      * finally the BSP epoch barrier: ``barrier(max(now(r)))``
        synchronizes all clocks to the slowest node.

    With ``sync="epoch"`` (default) the schedule is the PR 3 schedule,
    event for event.

    ``trace`` (ISSUE 10) is the optional flight recorder: the driver emits
    ``park`` / ``release`` / ``epoch-barrier`` events from this one shared
    loop, so barrier provenance is parity-free by construction.  With
    ``trace=None`` the schedule is byte-identical to an untraced run.
    """
    if sync not in ("epoch", "batch"):
        raise ValueError(f"unknown sync {sync!r}; expected 'epoch' or 'batch'")
    if sync == "batch" and batch_barrier is None:
        raise ValueError("sync='batch' needs a batch_barrier callback")
    if backup_workers < 0 or staleness_bound < 0:
        raise ValueError("backup_workers and staleness_bound must be >= 0")
    if (backup_workers or staleness_bound) and sync != "batch":
        raise ValueError("straggler mitigation requires sync='batch'")
    if backup_workers >= n_nodes:
        raise ValueError("backup_workers must leave at least one syncing rank")
    heap = [(now(rank), rank) for rank in range(n_nodes)]
    heapq.heapify(heap)
    parked: List[int] = []  # ranks waiting at the current allreduce barrier
    done_batches = [0] * n_nodes  # per-rank completed gradient batches
    barrier_round = 0  # allreduce barriers released so far
    active = n_nodes  # ranks whose epoch is not yet exhausted
    while heap or parked:
        if parked and (
            not heap or len(parked) >= max(1, active - backup_workers)
        ):
            # Enough running nodes reached a batch boundary: allreduce.
            t_bar = max(now(rank) for rank in parked)
            trace_emit(
                trace, "release", CLUSTER_NODE, t_bar,
                # Sorted: the parked *set* is schedule-determined, but its
                # arrival order is an engine detail (the vector engine
                # reaches equal-time boundaries in a different step order).
                round=barrier_round, ranks=tuple(sorted(parked)),
            )
            # Rounds finishing during the wait become visible — but never
            # fold past a straggler's own next event (fold safety).
            fold_all(t_bar if not heap else min(t_bar, heap[0][0]))
            assert batch_barrier is not None
            batch_barrier(t_bar, tuple(parked))
            for rank in parked:
                heapq.heappush(heap, (now(rank), rank))
            parked = []
            barrier_round += 1
            continue
        t, rank = heapq.heappop(heap)
        fold_all(t)
        signal = step(rank)
        if signal == STEP_DONE:
            active -= 1
            continue
        if sync == "batch" and signal == STEP_BATCH_END:
            done_batches[rank] += 1
            if done_batches[rank] > barrier_round + staleness_bound:
                parked.append(rank)
                trace_emit(
                    trace, "park", rank, now(rank),
                    batch=done_batches[rank], round=barrier_round,
                )
            else:
                # Behind (a dropped straggler) or within the staleness
                # window: skip this barrier and keep running.
                heapq.heappush(heap, (now(rank), rank))
        else:
            heapq.heappush(heap, (now(rank), rank))
    t_end = max(now(rank) for rank in range(n_nodes))
    trace_emit(trace, "epoch-barrier", CLUSTER_NODE, t_end)
    barrier(t_end)


def peer_probe_payload(
    registry: Optional["PeerCacheRegistry"], node_id: int, idx: int
) -> Optional[bytes]:
    """THE peer-probe sequence (registry lookup -> holder peek ->
    record_hit), shared by the demand path of both projections and the
    pre-fetch service, so the directory observes identical traffic
    everywhere.  Returns the peeked payload (real bytes on the runtime,
    :data:`SENTINEL` in the simulator) or None on a miss/eviction race."""
    if registry is None:
        return None
    holder = registry.lookup(idx, requester=node_id)
    if holder is None:
        return None
    payload = registry.cache_of(holder).peek(idx)
    if payload is None:
        return None  # evicted between lookup and read
    registry.record_hit()
    return payload


@dataclasses.dataclass
class SubstepAccess:
    """One demand read decomposed into sub-step events (ISSUE 4 tentpole).

    At ``granularity="step"`` a sample access is one scheduler event: the
    probe observes cluster state at the step's *start*, and the whole
    multi-component latency (peer RTT, bucket GET, CPU) elapses atomically
    — a prefetch round completing one microsecond into a 15.7 ms GET only
    becomes visible at the next step.  ``granularity="substep"`` makes each
    time component its own event.  :meth:`run` is a generator that yields
    control to ``drive_interleaved_epoch`` at every boundary where other
    cluster events may interleave:

      1. issue time ``t0``: local cache lookup (own completions folded);
         a RAM hit finishes the access in this event;
      2. on a local miss with a peer tier, the probe spends one RTT in
         flight — **yield** — and is evaluated against the *arrival-time*
         cluster state, so a round that completed inside that RTT turns the
         probe into a hit;
      3. payload transfer (peer streaming or the bucket GET, billed at
         issue) — **yield** — so peers fold and act *inside* the long GET,
         and this node's own insert-at-arrival happens at its true virtual
         time (the step schedule leaked demand inserts to later-code-order
         but earlier-virtual-time peer probes);
      4. arrival: miss-insert (when the demand path owns population), CPU
         overhead, per-sample accounting.

    Both projections construct this object around the same cost kernel
    (``repro.engine.kernels.DemandKernel``, precomputed from the same
    scaled models) and run the same generator — identical
    charge/record/yield order — which is what keeps sub-step specs inside
    the exact-parity domain.
    The component *sums* differ from the step schedule only on the peer-hit
    path (RTT and streaming are charged as two adds instead of one), so
    sub-step results are a different — more faithful — schedule, compared
    within, never across, granularities.
    """

    now: Callable[[], float]
    charge: Callable[[float], None]  # advance this node's clock
    fold_own: Callable[[], None]  # apply own prefetch completions <= now
    local_lookup: Callable[[int], Optional[bytes]]  # CappedCache.get
    peer_lookup: Optional[Callable[[int], Optional[bytes]]]  # None = no tier
    bucket_read: Callable[[int], bytes]  # bills the Class B GET at issue
    insert: Callable[[int, bytes], None]  # demand-path cache insert
    kernel: "DemandKernel"  # precomputed per-sample charge components
    insert_on_miss: bool
    node: int = 0  # rank the flight recorder attributes events to
    trace: Optional[TraceRecorder] = None

    def run(self, idx: int, stats: EpochStats) -> Iterator[int]:
        t0 = self.now()
        self.fold_own()
        payload = self.local_lookup(idx)
        components: List[Tuple[str, float]] = []
        class_b = 0
        if payload is not None:
            self.charge(self.kernel.ram_hit_s)
            stats.record("ram")
            tier = "ram"
            components.append(("local", self.kernel.ram_hit_s))
        else:
            if self.peer_lookup is not None:
                self.charge(self.kernel.probe_rtt_s)  # probe in flight
                components.append(("probe", self.kernel.probe_rtt_s))
                yield STEP_CONTINUE
                self.fold_own()
                payload = self.peer_lookup(idx)
            if payload is not None:
                self.charge(self.kernel.peer_stream_s)
                stats.record("peer")
                tier = "peer"
                components.append(("peer", self.kernel.peer_stream_s))
            else:
                payload = self.bucket_read(idx)
                self.charge(self.kernel.bucket_get_s)
                stats.record("bucket")
                tier = "bucket"
                class_b = 1
                components.append(("bucket", self.kernel.bucket_get_s))
            yield STEP_CONTINUE  # transfer in flight; rounds land inside it
            self.fold_own()
            if self.insert_on_miss:
                self.insert(idx, payload)
        self.charge(self.kernel.cpu_overhead_s)
        components.append(("cpu", self.kernel.cpu_overhead_s))
        stats.samples += 1
        dt = self.now() - t0
        stats.data_wait_seconds += dt
        trace_demand(
            self.trace, self.node, t0, dt, idx, tier, class_b, tuple(components)
        )


@dataclasses.dataclass
class BucketedBatchComm:
    """One gradient batch's bucketed compute/allreduce overlap pipeline
    (ISSUE 8 tentpole (b)) — the comm analogue of :class:`SubstepAccess`.

    Models the olmax-style bucketed training step: backprop emits the
    gradient in ``n_buckets`` pieces; each piece's allreduce issues as soon
    as (a) its backprop span has finished and (b) the single comm channel
    is free (bucket allreduces serialize on one channel), while the next
    span keeps computing.  At the end of the last span the node blocks
    only for the *exposed* tail of the last in-flight allreduce:

        finish_b = max(compute_end_b, finish_{b-1}) + bucket_comm_s
        exposed  = finish_last - compute_end_last      (>= 0)

    The exposed tail lands in ``allreduce_comm_seconds``; the per-batch
    barrier then charges **no** comm for overlap specs (it already
    happened here).  Since ``sum(bucket_comm_s) == allreduce_seconds`` is
    an exact partition (``CollectiveModel.bucket_seconds``), the exposed
    tail never exceeds the unbucketed duration — overlap can only hide
    communication, never add it.

    :meth:`run` is a generator yielding ``STEP_CONTINUE`` at every span
    boundary, so prefetch rounds and peer activity interleave inside the
    batch's compute exactly like sub-step access events.  Both projections
    run this generator verbatim — the simulator charges ``self.t += s``,
    the lock-step loader ``clock.sleep(s)`` (the identical float op) — so
    overlap specs stay inside the exact-parity domain.
    """

    now: Callable[[], float]
    charge: Callable[[float], None]  # advance this node's clock
    compute_span_s: float  # per-bucket backprop span (compute/n_buckets)
    bucket_comm_s: float  # per-bucket allreduce duration (comm/n_buckets)
    n_buckets: int
    node: int = 0  # rank the flight recorder attributes events to
    trace: Optional[TraceRecorder] = None

    def run(self, stats: EpochStats) -> Iterator[int]:
        finish = self.now()  # when the comm channel frees up
        for b in range(self.n_buckets):
            c0 = self.now()
            self.charge(self.compute_span_s)
            stats.compute_seconds += self.compute_span_s
            trace_emit(
                self.trace, "compute", self.node, c0, self.compute_span_s, bucket=b
            )
            ready = self.now()
            start = ready if ready > finish else finish
            finish = start + self.bucket_comm_s
            trace_emit(
                self.trace, "overlap-bucket", self.node, start,
                self.bucket_comm_s, bucket=b,
            )
            if b + 1 < self.n_buckets:
                yield STEP_CONTINUE
        exposed = finish - self.now()
        if exposed > 0:
            e0 = self.now()
            self.charge(exposed)
            stats.allreduce_comm_seconds += exposed
            trace_emit(self.trace, "overlap-exposed", self.node, e0, exposed)


class LockstepPrefetchService:
    """Deterministic pre-fetch service: completions are virtual-time events.

    One instance per node.  The constructor wires the node's calibrated
    models and sinks; ``issue`` starts a round at an explicit virtual time,
    ``advance_to`` folds every completed round's inserts into the cache.

    Parameters
    ----------
    cache: the node-local capped cache rounds insert into.
    sample_bytes / n_samples: the workload's object size and dataset size
        (timing is modelled on the *nominal* sample size, exactly like the
        simulator — payload bytes only carry content, never timing).
    bucket / network: calibrated models (Table I defaults upstream).
    store_stats: the ``StoreStats`` this node's Class A/B requests are
        billed to (the simulator's per-node accounting, or the runtime
        bucket store's stats object).
    payload_for: materializes the payload inserted for a key — the
        runtime's payload map; ``None`` inserts :data:`SENTINEL` (simulator
        mode, where caches count items).
    clock: optional clock backing the :meth:`request` convenience entry
        point (the runtime's per-node virtual clock).  ``issue`` itself
        never reads or advances any clock — callers pass ``now`` — so a
        round's modelled duration costs the training loop nothing.
    registry / node_id: the cooperative peer-cache directory, when the
        spec enables the peer tier.
    """

    def __init__(
        self,
        cache: CappedCache,
        *,
        sample_bytes: int,
        n_samples: int,
        bucket: BucketModel,
        network: NetworkModel,
        store_stats: StoreStats,
        n_connections: int = 16,
        list_every_fetch: bool = True,
        streaming_insert: bool = False,
        payload_for: Optional[Callable[[int], bytes]] = None,
        clock: Optional[Clock] = None,
        registry: Optional["PeerCacheRegistry"] = None,
        node_id: int = 0,
        trace: Optional[TraceRecorder] = None,
    ):
        self.cache = cache
        self.sample_bytes = sample_bytes
        self.n_samples = n_samples
        self.bucket = bucket
        self.network = network
        self.store_stats = store_stats
        self.n_connections = n_connections
        self.list_every_fetch = list_every_fetch
        self.streaming_insert = streaming_insert
        self.payload_for = payload_for
        self.clock = clock
        self.registry = registry
        self.node_id = node_id
        self.trace = trace
        # Flight-recorder provenance for issued rounds: the epoch drivers
        # stamp the installed planner's policy family here ("paper" /
        # "oracle" / "cluster-oracle") at epoch begin.  Observe-only — the
        # partition itself never reads it.
        self.provenance = "paper"
        # Event state: the single worker's availability + pending insert
        # events, each ``(completion_time, [(key, payload), ...])``.
        self.free_at = 0.0
        self.pending: List[Tuple[float, List[Tuple[int, bytes]]]] = []
        self.rounds = 0
        self.samples_fetched = 0
        # Round keys pulled from a peer's cache instead of the bucket.
        self.peer_fetches = 0
        # Cluster-placement state (``set_placement``): the keys THIS rank
        # owns (None = no placement, historical behaviour), keys deferred
        # because no peer held them yet, and a lifetime deferral counter.
        self._owned: Optional[frozenset] = None
        self._deferred: List[int] = []
        self._in_flight: Optional[set] = None
        self.placement_deferrals = 0

    def set_placement(
        self,
        owned: Optional[Sequence[int]],
        in_flight: Optional[set] = None,
    ) -> None:
        """Install the epoch's ownership set (cluster placement).  Called by
        both projections' epoch drivers right after the epoch planner is
        built; resets the deferral queue — deferred keys from a finished
        epoch are already past their uses.  ``in_flight`` is the
        cluster-SHARED issued-but-not-yet-inserted key set (one per
        ``ClusterPlacementPlanner``): every rank's service marks its bucket
        keys at issue and clears them at insertion, so any rank can tell "a
        copy of this key is on its way" from "no copy exists anywhere".
        Never cleared here — a round straddling the epoch barrier still
        clears its own keys at its insertion event."""
        self._owned = None if owned is None else frozenset(owned)
        self._in_flight = in_flight
        self._deferred = []

    # -- peer probe (identical sequence to the demand path) ------------------
    def _peer_probe(self, idx: int) -> bool:
        """True when a peer's cache can serve ``idx`` right now."""
        return peer_probe_payload(self.registry, self.node_id, idx) is not None

    def _payload(self, key: int) -> bytes:
        return SENTINEL if self.payload_for is None else self.payload_for(key)

    # -- event API -----------------------------------------------------------
    def issue(
        self,
        keys: Sequence[int],
        now: float,
        stats: Optional[EpochStats] = None,
        replay: bool = False,
    ) -> float:
        """Start one fetch round at virtual time ``now``; returns its
        completion time.  Class A/B billing happens here (request issue),
        insertion happens at the completion event (``advance_to``).

        ``replay=True`` marks a round *re-announced* during a mid-epoch
        checkpoint resume (``DeliLoader``): its keys were fetched — and
        billed — before the crash, so still-cached keys are filtered out
        and a fully-resident round is a no-op (no listing, no Class B, no
        worker time).  Keys the capped cache evicted since the checkpoint
        are genuinely gone and are re-fetched (and re-billed) as a normal
        round.  Never set for live rounds: live billing is parity-exact
        with the simulator, which fetches every announced key."""
        keys = list(keys)
        if replay:
            keys = [k for k in keys if not self.cache.contains(k)]
            if not keys:
                return now
        n_retry = 0
        if self._deferred:
            # Placement: keys deferred at earlier rounds (owner fetch in
            # flight then) retry ahead of this round's keys — their
            # deadlines are earlier.  Locally-resident ones are dropped: a
            # demand probe already pulled them.
            retry = [k for k in self._deferred if not self.cache.contains(k)]
            self._deferred = []
            n_retry = len(retry)
            keys = retry + keys
        start = max(now, self.free_at)
        listing_s = 0.0
        class_a = 0
        if self.list_every_fetch or self.rounds == 0:
            listing_s = self.bucket.list_seconds(self.n_samples)
            class_a = max(1, -(-self.n_samples // self.bucket.page_size))
            self.store_stats.class_a_requests += class_a
        # Peer tier: keys a peer already holds travel the inter-node network
        # (sequential RPCs) instead of costing bucket GETs; failed probes pay
        # the lookup RTT — the same charges as the demand path.  Under
        # cluster placement, a non-owned key whose probe failed splits on
        # the shared in-flight set: a fetch already issued somewhere means
        # the copy is on its way — defer and retry next round (a peer hit
        # by then).  No copy resident AND none in flight means the owner
        # fetched and later evicted it under capacity pressure (ownership
        # puts the owner's announce at or before any consumer's, so "not
        # yet issued" is the rare straggler race) — the consumer
        # bulk-fetches it itself.  The invariant is "never a duplicate
        # bucket GET while a copy is resident or in flight"; an absent copy
        # must not degrade a cheap amortized prefetch GET into a serial
        # demand GET.
        bucket_keys = keys
        fetch_keys = keys  # the keys this round actually delivers
        peer_s = 0.0
        n_peer = 0
        n_deferred = 0
        dup_keys: List[int] = []
        if self.registry is not None:
            bucket_keys = []
            fetch_keys = []
            for k in keys:
                probe_hit = self._peer_probe(k)
                trace_emit(
                    self.trace, "probe", self.node_id, now,
                    idx=k, hit=int(probe_hit),
                )
                if probe_hit:
                    n_peer += 1
                    fetch_keys.append(k)
                elif self._owned is None or k in self._owned:
                    bucket_keys.append(k)
                    fetch_keys.append(k)
                elif self._in_flight is None or k in self._in_flight:
                    self._deferred.append(k)
                    n_deferred += 1
                else:
                    # Owner copy neither resident nor in flight: duplicate
                    # (bulk) GET beats a guaranteed serial demand GET.
                    bucket_keys.append(k)
                    fetch_keys.append(k)
                    dup_keys.append(k)
            self.placement_deferrals += n_deferred
            if self._in_flight is not None:
                self._in_flight.update(bucket_keys)
            peer_s = n_peer * self.network.transfer_seconds(
                self.sample_bytes
            ) + (len(bucket_keys) + n_deferred) * self.network.lookup_seconds()
            self.peer_fetches += n_peer
            if stats is not None and n_peer:
                stats.record("peer", n_peer)
        # The round's keys are known at issue, so the (naive) per-round
        # listing proceeds CONCURRENTLY with the parallel GETs — it is pure
        # Class A accounting traffic, not a serialization point.
        dur = max(
            listing_s,
            self.bucket.bulk_get_seconds(
                [self.sample_bytes] * len(bucket_keys), self.n_connections
            )
            + peer_s,
        )
        done = start + dur
        self.store_stats.class_b_requests += len(bucket_keys)
        self.store_stats.bytes_read += len(bucket_keys) * self.sample_bytes
        self.store_stats.read_seconds += dur
        trace_emit(
            self.trace, "issue", self.node_id, start, dur,
            round=self.rounds, provenance=self.provenance, done=done,
            n_keys=len(keys), n_retry=n_retry, n_peer=n_peer,
            n_bucket=len(bucket_keys) - len(dup_keys), n_dup=len(dup_keys),
            n_deferred=n_deferred, dup=tuple(dup_keys),
            keys=tuple(bucket_keys),
            class_a=class_a, class_b=len(bucket_keys),
        )
        items = [(k, self._payload(k)) for k in fetch_keys]
        if self.streaming_insert:
            # Spread inserts uniformly across the round duration (insert
            # order still matters for FIFO eviction).  A fully-deferred
            # placement round delivers nothing (items empty) yet still
            # advances the worker clock by its probe RTTs.
            if items:
                per = dur / len(items)
                for j, item in enumerate(items):
                    self.pending.append((start + per * (j + 1), [item]))
        elif items:
            self.pending.append((done, items))
        self.free_at = done
        self.rounds += 1
        return done

    def advance_to(self, now: float) -> int:
        """Fold every round completed by virtual time ``now`` into the
        cache (bulk insert, round order then key order); returns the number
        of samples inserted.  This is the completion *event* — callers
        invoke it at the defined barriers (own sample access; every
        interleaved-scheduler step for peers)."""
        if not self.pending:
            return 0
        inserted = 0
        remaining: List[Tuple[float, List[Tuple[int, bytes]]]] = []
        for done, items in self.pending:
            if done <= now:
                # Cache-insert events pin to the round's completion time:
                # the fold may be driven by another node's clock (fold_all),
                # which must never leak into this node's timestamps.
                if self.trace is not None:
                    self.trace.pin(done)
                for k, payload in items:
                    self.cache.put(k, payload)
                    if self._in_flight is not None:
                        self._in_flight.discard(k)
                if self.trace is not None:
                    self.trace.unpin()
                    self.trace.emit(
                        "advance", self.node_id, done,
                        n=len(items), keys=tuple(k for k, _ in items),
                    )
                inserted += len(items)
            else:
                remaining.append((done, items))
        self.pending = remaining
        self.samples_fetched += inserted
        return inserted

    # -- runtime-facing conveniences (PrefetchService-shaped) ----------------
    def request(
        self,
        keys: Sequence[int],
        stats: Optional[EpochStats] = None,
        replay: bool = False,
    ) -> float:
        """Loader entry point: issue a round at the node clock's now."""
        if self.clock is None:
            raise ValueError(
                "request() needs the service constructed with a clock; "
                "clockless callers (the simulator) use issue(keys, now=...)"
            )
        return self.issue(keys, now=self.clock.now(), stats=stats, replay=replay)

    def drain(self, timeout: float = 0.0) -> bool:
        """No-op: lock-step completions are *events*, folded strictly by
        ``advance_to`` at the parity barriers — force-completing them here
        would diverge from the simulator.  Exists for interface symmetry
        with the threaded ``PrefetchService``."""
        return True

    def close(self) -> None:
        """No worker thread to stop; interface symmetry only."""

    def __enter__(self) -> "LockstepPrefetchService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
