"""Virtual-time flight recorder: the event model and shared emit helpers.

The recorder is an *observer* of the lock-step schedule (ISSUE 10): both
projections — the discrete-event simulator and the lock-step runtime —
emit structured :class:`TraceEvent` rows at the same virtual times with
the same attributes, so the parity discipline extends from aggregate
counters to **event-level ``==``** (``repro.obs.parity``).

Observer purity (rule PL006, ``repro.analysis``): nothing in this package
may mutate scheduler, cache, or stats state.  Host code calls *into* the
recorder (``trace_emit`` / ``trace_sync`` / the ``CacheTracer`` callbacks);
the recorder never calls back into the data plane.  With ``trace=None``
every guarded emit helper is a no-op and the schedule is byte-identical to
an untraced run.

This module is deliberately stdlib-only and imports nothing from
``repro`` — ``repro.core.lockstep`` (the dependency root of the data
plane) imports it without cycles.

Event vocabulary (see docs/OBSERVABILITY.md for the full schema):

==================  ========================================================
kind                meaning
==================  ========================================================
``demand``          one training-loop sample read (tier-attributed span)
``issue``           one pre-fetch round issued (provenance + key partition)
``advance``         one pre-fetch round folded into the cache at its
                    completion time
``probe``           one service-side peer probe with its arrival-time
                    outcome
``insert``          a cache insert (demand fill or pre-fetch fold)
``evict``           a cache eviction (victim + policy)
``compute``         a training compute span (per batch, or per gradient
                    bucket under ``overlap="buckets"``)
``allreduce-wait``  time blocked at a gradient-sync barrier (skew)
``allreduce-comm``  time transferring gradient bytes (exposed comm)
``overlap-bucket``  one gradient bucket's allreduce transfer (hidden or not)
``park``            a rank parked at the batch barrier (driver event)
``release``         a barrier release (driver event, node ``-1``)
``epoch-barrier``   the end-of-epoch BSP barrier (driver event, node ``-1``)
==================  ========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Optional, Tuple

#: Driver-level events (barrier machinery) are recorded on this pseudo-node.
CLUSTER_NODE = -1


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One structured event at a virtual time.

    ``attrs`` is a key-sorted tuple of ``(name, value)`` pairs; values are
    restricted by convention to ints, floats, strings and flat tuples so
    events stay hashable, comparable and JSON-renderable.  Payload bytes
    never enter an event: the runtime carries real sample bytes and the
    simulator carries sentinels, so payloads are exactly the thing trace
    parity must not see.
    """

    kind: str
    node: int
    t: float
    dur: float = 0.0
    attrs: Tuple[Tuple[str, Any], ...] = ()

    def attr(self, key: str, default: Any = None) -> Any:
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def canon(self) -> tuple:
        """The canonical comparison tuple (see :func:`canonical_stream`)."""
        return (self.node, self.t, self.kind, self.dur, self.attrs)


class TraceRecorder:
    """Append-only event sink shared by every instrumented component.

    One recorder observes one projection of one run (all nodes).  The
    *pin* is the round-completion idiom: ``LockstepPrefetchService
    .advance_to`` folds finished rounds into caches while some *other*
    node's clock drives the fold, so cache-insert timestamps pin to the
    round's completion time instead of the caller's clock.
    """

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        self._pin: Optional[float] = None

    def emit(
        self, kind: str, node: int, t: float, dur: float = 0.0, **attrs: Any
    ) -> None:
        self.events.append(
            TraceEvent(kind, int(node), float(t), float(dur), tuple(sorted(attrs.items())))
        )

    # -- pinned time --------------------------------------------------------
    def pin(self, t: float) -> None:
        self._pin = float(t)

    def unpin(self) -> None:
        self._pin = None

    @property
    def pinned(self) -> Optional[float]:
        return self._pin

    def __len__(self) -> int:
        return len(self.events)


def canonical_stream(events: Iterable[TraceEvent]) -> Tuple[tuple, ...]:
    """The order-canonical form two streams are compared ``==`` on.

    Events are keyed ``(node, t, kind, dur, attrs)`` and sorted: within one
    node the virtual-time order is total, but *global* emission order is an
    engine detail (the vector engine commits whole segments at once), so
    the canonical form is a function of the event multiset only.  Ties
    break on the remaining tuple fields, which is deterministic because
    equal ``(node, t, kind)`` implies the same attribute keys.
    """
    return tuple(sorted(e.canon() for e in events))


class CacheTracer:
    """Observe one node's ``CappedCache`` through the dedicated trace
    listener slot (``CappedCache.set_trace_listener``).

    Timestamps come from the node's clock callable unless the recorder has
    a pinned time (pre-fetch folds).  The vector engine runs its cache
    walk *before* committing the time chain, so it switches the tracer to
    capture mode and flushes ``(op, index)`` rows with chain-derived
    timestamps at segment commit.
    """

    def __init__(
        self,
        trace: TraceRecorder,
        node: int,
        now: Callable[[], float],
        policy: str = "",
    ) -> None:
        self.trace = trace
        self.node = int(node)
        self.now = now
        self.policy = policy
        self._capture: Optional[List[Tuple[str, int]]] = None

    def _t(self) -> float:
        pin = self.trace.pinned
        return pin if pin is not None else self.now()

    # -- CappedCache trace-listener callbacks -------------------------------
    def on_insert(self, index: int) -> None:
        if self._capture is not None:
            self._capture.append(("insert", index))
            return
        self.trace.emit("insert", self.node, self._t(), idx=index)

    def on_evict(self, index: int) -> None:
        if self._capture is not None:
            self._capture.append(("evict", index))
            return
        self.trace.emit("evict", self.node, self._t(), victim=index, policy=self.policy)

    # -- vector-engine capture mode -----------------------------------------
    def begin_capture(self) -> List[Tuple[str, int]]:
        self._capture = []
        return self._capture

    def end_capture(self) -> List[Tuple[str, int]]:
        buf = self._capture if self._capture is not None else []
        self._capture = None
        return buf

    def flush(self, ops: Iterable[Tuple[str, int]], t: float) -> None:
        """Emit captured rows at the chain-derived time ``t``."""
        for op, index in ops:
            if op == "insert":
                self.trace.emit("insert", self.node, t, idx=index)
            else:
                self.trace.emit("evict", self.node, t, victim=index, policy=self.policy)


# -- guarded emit helpers (host-side; every call site is a no-op untraced) --
def trace_emit(
    trace: Optional[TraceRecorder],
    kind: str,
    node: int,
    t: float,
    dur: float = 0.0,
    **attrs: Any,
) -> None:
    """The generic guarded emit — one branch, zero cost when untraced."""
    if trace is not None:
        trace.emit(kind, node, t, dur, **attrs)


def trace_demand(
    trace: Optional[TraceRecorder],
    node: int,
    t0: float,
    dur: float,
    idx: int,
    tier: str,
    class_b: int = 0,
    components: Tuple[Tuple[str, float], ...] = (),
) -> None:
    """One tier-attributed demand read.

    ``dur`` is the exact float both projections add to
    ``EpochStats.data_wait_seconds`` for this sample; ``class_b`` is the
    number of Class B GETs the read billed (the ledger reconciles these
    against ``StoreStats``, docs/OBSERVABILITY.md).  ``components`` carries
    per-component substep timing when ``granularity="substep"``.
    """
    if trace is None:
        return
    if components:
        trace.emit(
            "demand", node, t0, dur,
            idx=idx, tier=tier, class_b=class_b, components=tuple(components),
        )
    else:
        trace.emit("demand", node, t0, dur, idx=idx, tier=tier, class_b=class_b)


def trace_sync(
    trace: Optional[TraceRecorder],
    node: int,
    end: float,
    wait: float,
    comm: float,
) -> None:
    """THE shared emit helper for the mirrored ``sync_to`` halves.

    Rule PL006 forbids raw recorder calls inside ``# parity-mirror``
    regions; the mirrored allreduce accounting instead makes this one
    call with the post-sync clock value (``end``), the barrier skew
    (``wait``) and the collective duration (``comm``) — all floats both
    halves already computed identically — and the spans are reconstructed
    here, outside the mirror, once.
    """
    if trace is None:
        return
    mark = end - comm if comm > 0 else end
    if wait > 0:
        trace.emit("allreduce-wait", node, mark - wait, wait)
    if comm > 0:
        trace.emit("allreduce-comm", node, mark, comm)
