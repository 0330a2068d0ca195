"""Storage bandwidth/latency models, calibrated to the paper's Table I.

Table I (3-node GCE VMs, us-east-1c, reading MNIST into memory):

    Disk                          18.63 MB/s   (many small files)
    Object storage, sequential    49.80 kB/s
    Object storage, 16 threads   281.73 kB/s   (= 5.66x sequential)

Model
-----
A bucket GET of ``size`` bytes costs

    t = request_latency + size / per_connection_bw

For MNIST-sized samples (784 B) the latency term dominates, which is exactly
why the paper observes kB/s-scale throughput.  Calibration:

  * sequential 49.8 kB/s on 784 B objects  =>  request_latency ~= 15.7 ms
    (784 B / 49.8 kB/s = 15.74 ms; the streaming term at 20 MB/s adds 39 us).
  * 16 threads give only 5.66x, not 16x (2 vCPUs, GIL, TCP setup): we model
    sub-linear parallel scaling  eff(n) = n ** alpha  with
    alpha = ln(5.66)/ln(16) ~= 0.626.
  * Disk at 18.63 MB/s is a pure-bandwidth regime for the small-file read
    pattern Table I measures (seek cost folded into the effective rate).

The paper measures *data loading time* at the training loop, which includes
per-sample CPU work (decode/collate).  We model that as ``cpu_overhead`` per
sample; it is what keeps the measured disk-vs-bucket gap at the paper's
8-16x rather than the raw 374x bandwidth ratio (§V-B discussion).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class BucketModel:
    """Simulated GCS bucket performance model."""

    request_latency_s: float = 784 / 49.80e3 - 784 / 20e6  # ~15.7 ms (Table I)
    per_connection_bw: float = 20e6  # bytes/s once a GET is streaming
    parallel_alpha: float = math.log(281.73 / 49.80) / math.log(16.0)  # ~0.626
    max_connections: int = 16
    # Listing (Class A) requests: latency per page.
    listing_latency_s: float = 0.050
    page_size: int = 1000

    def get_seconds(self, size_bytes: int) -> float:
        """Duration of a single sequential GET."""
        return self.request_latency_s + size_bytes / self.per_connection_bw

    def parallel_efficiency(self, n_connections: int) -> float:
        """Effective speedup of ``n`` concurrent GETs over sequential."""
        n = max(1, min(n_connections, self.max_connections))
        return float(n) ** self.parallel_alpha

    def bulk_get_seconds(self, sizes: list, n_connections: int = 16) -> float:
        """Duration of fetching ``len(sizes)`` objects over a thread pool.

        Total sequential work divided by the calibrated parallel efficiency
        (processor-sharing approximation of a thread pool on a small VM).
        """
        if not sizes:
            return 0.0
        seq = 0.0
        for s in sizes:
            seq += self.get_seconds(s)
        return seq / self.parallel_efficiency(n_connections)

    def list_seconds(self, n_objects: int) -> float:
        pages = max(1, math.ceil(n_objects / self.page_size))
        return pages * self.listing_latency_s

    def sequential_throughput(self, sample_bytes: int) -> float:
        """bytes/s — should reproduce Table I's 49.8 kB/s at ~1 kB objects."""
        return sample_bytes / self.get_seconds(sample_bytes)

    def parallel_throughput(self, sample_bytes: int, n: int = 16) -> float:
        return self.sequential_throughput(sample_bytes) * self.parallel_efficiency(n)


@dataclasses.dataclass(frozen=True)
class DiskModel:
    """Local persistent-disk model (Table I's small-file read regime)."""

    effective_bw: float = 18.63e6  # bytes/s
    seek_latency_s: float = 0.0  # folded into effective_bw per Table I

    def get_seconds(self, size_bytes: int) -> float:
        return self.seek_latency_s + size_bytes / self.effective_bw


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Inter-node (intra-cluster) network model for the cooperative peer
    cache tier (Hoard/NoPFS direction: nodes serve each other's misses).

    Defaults model the GCE VM-to-VM path in one zone: ~0.2 ms RTT and a
    ~10 Gbit/s per-flow ceiling.  For MNIST-sized samples the round trip
    dominates (~0.2 ms vs ~15.7 ms for a bucket GET) — a peer hit is two
    orders of magnitude cheaper than the Class B fallback, which is the
    entire premise of the tier.
    """

    rtt_s: float = 0.2e-3  # request/response round trip, same-zone VMs
    bw: float = 1.25e9  # bytes/s (~10 Gbit/s per flow)

    def transfer_seconds(self, size_bytes: int) -> float:
        """Duration of fetching one object from a peer's cache."""
        return self.rtt_s + size_bytes / self.bw

    def lookup_seconds(self) -> float:
        """A metadata-only peer lookup that misses (half a round trip is
        pipelined with the fallback GET; we charge the full RTT to stay
        conservative)."""
        return self.rtt_s

    def stream_seconds(self, size_bytes: int) -> float:
        """Payload streaming time *after* the probe round trip — the second
        half of ``transfer_seconds`` when the sub-step schedule charges the
        probe RTT (``lookup_seconds``) as its own event first."""
        return size_bytes / self.bw


@dataclasses.dataclass(frozen=True)
class CollectiveModel:
    """Gradient-allreduce cost model on top of the calibrated intra-cluster
    ``NetworkModel``.

    The per-batch barrier (``sync="batch"``) historically released ranks
    instantaneously once all arrived — skew was modeled, transfer was not.
    This model gives the allreduce a duration so blocked time splits into
    ``allreduce_wait_seconds`` (skew: waiting for stragglers to arrive) and
    ``allreduce_comm_seconds`` (transfer: moving gradient bytes).

    Two standard algorithms over ``n`` ranks exchanging ``gradient_bytes``:

      * ``"ring"`` — bandwidth-optimal reduce-scatter + all-gather:
        ``2(n-1)`` steps, each moving ``bytes/n`` over the per-flow link
        and paying one RTT of synchronization latency.
      * ``"tree"`` — latency-favoring reduce + broadcast:
        ``2*ceil(log2 n)`` rounds, each moving the full buffer once.

    Both are lower-bounded by the textbook ``2(n-1)/n * bytes / bw``
    (every rank must receive all but its own shard, twice).

    ``n_buckets`` decomposes the gradient for ``overlap="buckets"``: each
    bucket's allreduce costs exactly ``allreduce_seconds(...)/n_buckets``
    (latency amortized across the pipelined bucket stream — the olmax-style
    bucketed step this models issues them back-to-back on one channel), so
    bucketed total comm equals the unbucketed duration and overlap can only
    hide, never add, time.

    ``gradient_bytes=0`` is the free-allreduce limit: every duration is
    exactly 0.0, which must reproduce the historical instantaneous-barrier
    timeline bit-for-bit (the accounting-split bugfix's pin).
    """

    gradient_bytes: int
    algorithm: str = "ring"
    n_buckets: int = 4

    def __post_init__(self) -> None:
        if self.gradient_bytes < 0:
            raise ValueError("gradient_bytes must be >= 0")
        if self.algorithm not in ("ring", "tree"):
            raise ValueError(f"unknown collective algorithm {self.algorithm!r}")
        if self.n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")

    def allreduce_seconds(self, network: NetworkModel, n_ranks: int) -> float:
        """Duration of one full-gradient allreduce across ``n_ranks``."""
        if n_ranks <= 1 or self.gradient_bytes == 0:
            return 0.0
        if self.algorithm == "ring":
            steps = 2 * (n_ranks - 1)
            return steps * (network.rtt_s + (self.gradient_bytes / n_ranks) / network.bw)
        rounds = 2 * math.ceil(math.log2(n_ranks))
        return rounds * (network.rtt_s + self.gradient_bytes / network.bw)

    def bucket_seconds(self, network: NetworkModel, n_ranks: int) -> float:
        """Duration of one gradient bucket's allreduce (exact 1/n_buckets
        partition of the full duration — see class docstring)."""
        return self.allreduce_seconds(network, n_ranks) / self.n_buckets

    def ring_lower_bound_seconds(self, network: NetworkModel, n_ranks: int) -> float:
        """The algorithm-independent bandwidth lower bound
        ``2(n-1)/n * bytes / bw`` — both algorithms cost at least this."""
        if n_ranks <= 1 or self.gradient_bytes == 0:
            return 0.0
        return 2 * (n_ranks - 1) / n_ranks * self.gradient_bytes / network.bw


def mnist_cnn_gradient_bytes() -> int:
    """Gradient payload of the paper's 2-conv MNIST CNN, in fp32 bytes.

    conv1: 32 filters x (1 ch x 5x5 + bias)      =     832 params
    conv2: 64 filters x (32 ch x 5x5 + bias)     =  51,264 params
    fc1:   3136 -> 128 (+bias)                   = 401,536 params
    fc2:   128 -> 10 (+bias)                     =   1,290 params
    """
    conv1 = 32 * (1 * 25 + 1)
    conv2 = 64 * (32 * 25 + 1)
    fc1 = 3136 * 128 + 128
    fc2 = 128 * 10 + 10
    return 4 * (conv1 + conv2 + fc1 + fc2)


def arch_gradient_bytes(name: str) -> int:
    """fp32 gradient payload for one of the assigned arch configs
    (``repro.configs``).  Imported lazily: the configs package pulls in
    jax, which the pure-Python data plane must not require."""
    from repro_torch import configs

    return 4 * configs.get(name).param_count()


@dataclasses.dataclass(frozen=True)
class PipelineCostModel:
    """Per-sample CPU-side cost of the data pipeline (decode + collate).

    Calibrated so the measured disk/bucket data-wait ratio lands in the
    paper's 8-16x band for MNIST-sized samples (see module docstring).
    """

    cpu_overhead_s: float = 1.3e-3
    # RAM-tier cache hit (the explicit analogue of MongoDB/WiredTiger's
    # in-memory cache the paper credits for beating the disk baseline).
    ram_hit_s: float = 0.05e-3
    # Disk-tier cache hit: one small read from the local cache spill.
    disk_hit_s: float = 0.4e-3


@dataclasses.dataclass(frozen=True)
class NodeProfile:
    """Per-node heterogeneity: multiplicative *time* scales (straggler knobs).

    The paper's 3-VM cluster is homogeneous, but real data-parallel jobs are
    not: NoPFS's per-step I/O traces show stragglers dominating distributed
    training I/O, and the per-batch allreduce schedule exists precisely to
    model them.  A profile slows one node down deterministically:

      * ``compute``   — multiplies CPU-side times (per-batch compute, the
        per-sample decode/collate overhead, and cache-hit service times);
      * ``bandwidth`` — multiplies I/O times (bucket GET latency and
        streaming, disk reads, inter-node network RTT and streaming).

    1.0 = the calibrated baseline; 2.0 = twice as slow.  Scaling is applied
    by *rebuilding the calibrated models* (``scale_bucket`` etc.), so both
    execution projections evaluate the identical scaled floats and exact
    parity holds for straggler specs too.  Multiplying by 1.0 is a bitwise
    no-op for IEEE-754 finite values, so default profiles leave every
    existing timeline bit-for-bit unchanged.
    """

    compute: float = 1.0
    bandwidth: float = 1.0

    def __post_init__(self) -> None:
        if self.compute <= 0 or self.bandwidth <= 0:
            raise ValueError("NodeProfile multipliers must be positive")

    def scale_bucket(self, model: BucketModel) -> BucketModel:
        b = self.bandwidth
        return dataclasses.replace(
            model,
            request_latency_s=model.request_latency_s * b,
            per_connection_bw=model.per_connection_bw / b,
            listing_latency_s=model.listing_latency_s * b,
        )

    def scale_disk(self, model: DiskModel) -> DiskModel:
        b = self.bandwidth
        return dataclasses.replace(
            model,
            effective_bw=model.effective_bw / b,
            seek_latency_s=model.seek_latency_s * b,
        )

    def scale_network(self, model: NetworkModel) -> NetworkModel:
        b = self.bandwidth
        return dataclasses.replace(model, rtt_s=model.rtt_s * b, bw=model.bw / b)

    def scale_pipeline(self, model: PipelineCostModel) -> PipelineCostModel:
        c = self.compute
        return dataclasses.replace(
            model,
            cpu_overhead_s=model.cpu_overhead_s * c,
            ram_hit_s=model.ram_hit_s * c,
            disk_hit_s=model.disk_hit_s * c,
        )

    def batch_compute_s(self, compute_per_batch_s: float) -> float:
        """This node's per-batch compute time (straggler-scaled)."""
        return compute_per_batch_s * self.compute


DEFAULT_PROFILE = NodeProfile()


def straggler_profiles(
    n_nodes: int,
    slow_ranks: tuple = (0,),
    compute: float = 2.0,
    bandwidth: float = 2.0,
) -> tuple:
    """A cluster profile with ``slow_ranks`` slowed by the given factors —
    the canonical straggler scenario (``pipeline.registry`` condition
    ``"straggler"``, ``benchmarks/fig11_stragglers.py``)."""
    return tuple(
        NodeProfile(compute=compute, bandwidth=bandwidth)
        if rank in slow_ranks
        else NodeProfile()
        for rank in range(n_nodes)
    )


DEFAULT_BUCKET = BucketModel()
DEFAULT_DISK = DiskModel()
DEFAULT_PIPELINE = PipelineCostModel()
DEFAULT_NETWORK = NetworkModel()
