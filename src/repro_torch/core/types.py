"""Core datatypes shared across the DELI data plane.

Everything in the data plane speaks in terms of *sample keys* (dataset
indices), *payloads* (bytes), and *fetch requests* (ordered batches of keys
handed to the pre-fetch service).  Keeping these plain dataclasses (no jax,
no numpy requirements) lets the policy layer, the discrete-event simulator
and the threaded runtime share one vocabulary.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, Optional, Sequence

#: Tiers whose hits count as *local cache* hits.  Defined here (the
#: dependency root) and re-exported by ``repro.pipeline.tiers`` as part of
#: the tier API — one source of truth for hit/miss derivation.
LOCAL_TIERS = ("ram", "disk")


class StorageClass(enum.Enum):
    """GCP object-store request classes (drives the cost model)."""

    CLASS_A = "class_a"  # listing / mutation requests ($0.05 / 10k, paper §III-C)
    CLASS_B = "class_b"  # object GET requests          ($0.002 / 10k, paper §III-C)


@dataclasses.dataclass(frozen=True)
class SampleKey:
    """Identity of one training sample within a session.

    ``index`` is the dataset index; ``session`` mirrors the paper's
    "unique ID for the current training session" used in the MongoDB
    multi-key index (§IV-B) so stale cache entries from a previous run
    never produce hits.
    """

    index: int
    session: str = "default"


@dataclasses.dataclass
class Sample:
    key: SampleKey
    payload: bytes

    @property
    def nbytes(self) -> int:
        return len(self.payload)


@dataclasses.dataclass
class FetchRequest:
    """One pre-fetch round: 'cache these keys, in this order'."""

    keys: tuple
    request_id: int
    issued_at: float  # seconds (virtual or wall clock)


@dataclasses.dataclass
class StoreStats:
    """Request accounting for one store (feeds the cost model Eq. 3-5)."""

    class_a_requests: int = 0
    class_b_requests: int = 0
    bytes_read: int = 0
    read_seconds: float = 0.0  # total time spent inside reads

    def merge(self, other: "StoreStats") -> "StoreStats":
        return StoreStats(
            self.class_a_requests + other.class_a_requests,
            self.class_b_requests + other.class_b_requests,
            self.bytes_read + other.bytes_read,
            self.read_seconds + other.read_seconds,
        )


@dataclasses.dataclass
class EpochStats:
    """Per-node, per-epoch data-plane metrics (the paper's two metrics).

    Attribution is a *per-tier counter map*: ``tier_hits[tier]`` counts
    reads served by that tier ("ram"/"disk" = local cache, "peer" = a peer
    node's cache over the network, "bucket" = a Class B object GET).  The
    legacy scalar fields (``hits``, ``misses``, ``ram_hits``,
    ``peer_hits``) survive as derived properties so every seed-era consumer
    keeps working.

    Peer accounting note (unchanged semantics from PR 1): a demand read
    served by a peer is recorded under ``tier_hits["peer"]`` and still
    counts as a local-cache miss.  The simulator additionally folds
    pre-fetch round pulls into the "peer" counter; the threaded runtime
    reports service-side pulls on ``PrefetchService.peer_fetches`` /
    ``PeerStore.peer_hits`` instead (the async service can't attribute them
    to an epoch).
    """

    epoch: int
    node: int
    samples: int = 0
    data_wait_seconds: float = 0.0  # time the training loop blocked on data
    compute_seconds: float = 0.0
    # Time blocked at gradient-synchronization (allreduce) barriers.  Only
    # the per-batch BSP schedule (``sync="batch"``) accounts it; the legacy
    # epoch-barrier schedule leaves it 0.0 (ISSUE 4).
    allreduce_wait_seconds: float = 0.0
    # Time spent *transferring* gradient bytes in the allreduce itself
    # (``CollectiveModel`` duration, ISSUE 8).  Zero unless a collective
    # cost model is configured; with ``overlap="buckets"`` only the
    # non-hidden (exposed) fraction lands here.
    allreduce_comm_seconds: float = 0.0
    evictions: int = 0
    tier_hits: Dict[str, int] = dataclasses.field(default_factory=dict)

    def record(self, tier: str, n: int = 1) -> None:
        """Attribute ``n`` reads to ``tier``."""
        self.tier_hits[tier] = self.tier_hits.get(tier, 0) + n

    def tier(self, name: str) -> int:
        return self.tier_hits.get(name, 0)

    # -- legacy scalar views -------------------------------------------------
    @property
    def hits(self) -> int:
        """Local-cache hits (RAM + spill-disk tiers)."""
        return sum(self.tier_hits.get(t, 0) for t in LOCAL_TIERS)

    @property
    def misses(self) -> int:
        """Local-cache misses: every sample access not served locally
        (includes peer-served reads — the local cache did miss — and the
        disk-source baseline, which has no cache at all)."""
        return self.samples - self.hits

    @property
    def ram_hits(self) -> int:
        return self.tier_hits.get("ram", 0)

    @property
    def disk_hits(self) -> int:
        return self.tier_hits.get("disk", 0)

    @property
    def peer_hits(self) -> int:
        return self.tier_hits.get("peer", 0)

    @property
    def bucket_reads(self) -> int:
        return self.tier_hits.get("bucket", 0)

    @property
    def wall_seconds(self) -> float:
        """The node's busy+blocked time inside the epoch: data-wait +
        compute + allreduce waits + allreduce transfer.  Under
        ``sync="batch"`` this is the node's barrier-to-barrier epoch
        duration (fig11's metric).  With zero collective cost the comm
        term is 0.0 and this reproduces the pre-ISSUE-8 total exactly.
        This is also exactly the per-rank row of the flight recorder's
        wall-time decomposition (``repro.obs.export.decomposition``):
        each traced span's duration is the very float added to the
        matching field, so the table sums back to this property with
        ``==``."""
        return (
            self.data_wait_seconds
            + self.compute_seconds
            + self.allreduce_wait_seconds
            + self.allreduce_comm_seconds
        )

    @property
    def wall_clock_seconds(self) -> float:
        """Legacy alias of :attr:`wall_seconds` (seed-era consumers)."""
        return self.wall_seconds

    def asdict(self) -> Dict[str, object]:
        """A stable plain-dict form: exactly the constructor fields, so
        ``EpochStats(**s.asdict()) == s`` round-trips (``tier_hits`` is
        copied, not aliased).  Derived properties are deliberately
        excluded — serialize facts, recompute views."""
        return {
            "epoch": self.epoch,
            "node": self.node,
            "samples": self.samples,
            "data_wait_seconds": self.data_wait_seconds,
            "compute_seconds": self.compute_seconds,
            "allreduce_wait_seconds": self.allreduce_wait_seconds,
            "allreduce_comm_seconds": self.allreduce_comm_seconds,
            "evictions": self.evictions,
            "tier_hits": dict(self.tier_hits),
        }

    @property
    def miss_rate(self) -> float:
        return self.misses / self.samples if self.samples else 0.0

    @property
    def hit_rate(self) -> float:
        return 1.0 - self.miss_rate


def aggregate_tier_hits(stats: Iterable["EpochStats"]) -> Dict[str, int]:
    """Sum per-tier counters over epochs/nodes (benchmark tables, parity)."""
    out: Dict[str, int] = {}
    for s in stats:
        for tier, n in s.tier_hits.items():
            out[tier] = out.get(tier, 0) + n
    return out


def sequential_sum(values: Iterable[float]) -> float:
    """Left-to-right float accumulation, spelled out.

    The parity contract forbids leaning on a fold whose order is an
    implementation detail (builtin ``sum`` happens to be sequential,
    ``np.sum`` is pairwise) — every float reduction in the sim domain uses
    this explicit chain, the scalar twin of ``np.cumsum(xs)[-1]``
    (see repro/engine/vector.py)."""
    total = 0.0
    for v in values:
        total += v
    return total


@dataclasses.dataclass
class RunStats:
    """Aggregate over epochs/nodes; what benchmarks report."""

    epochs: Sequence[EpochStats]
    store_stats: Optional[StoreStats] = None

    def epoch(self, e: int) -> Sequence[EpochStats]:
        return [s for s in self.epochs if s.epoch == e]

    def mean_miss_rate(self, e: int) -> float:
        rows = self.epoch(e)
        return sequential_sum(r.miss_rate for r in rows) / len(rows) if rows else 0.0

    def mean_data_wait(self, e: int) -> float:
        rows = self.epoch(e)
        return (
            sequential_sum(r.data_wait_seconds for r in rows) / len(rows)
            if rows
            else 0.0
        )

    def total_data_wait(self) -> float:
        return sequential_sum(r.data_wait_seconds for r in self.epochs)
