"""Engine-agnostic per-sample cost kernels (ISSUE 6 tentpole).

The per-sample data-plane cost arithmetic — which float components a demand
read charges, in which order, and what it bills to the object store — used
to live three times: in ``NodeSimulator._access`` (the scalar event
engine), in ``SubstepAccess.run`` (the sub-step decomposition shared by
both projections) and in ``DeliLoader._sample_steps`` (the lock-step
runtime's modelled loop costs).  Introducing a *second* execution engine
(``repro.engine.vector``) would have made it four.  This module is the ONE
home:

  * :class:`DemandKernel` precomputes every per-sample charge component
    from a node's (profile-scaled) calibrated models.  Each component is a
    pure function of fixed inputs, so precomputing it yields bit-identical
    floats to recomputing it per access — the parity discipline
    (docs/PARITY.md) is preserved by construction.
  * :meth:`DemandKernel.tier_charges` maps a serving tier to its ordered
    charge tuple for the step-granularity schedule.  The scalar engine
    accumulates the tuple left-to-right with ``t += c``; the vector engine
    lays the same components into a flat charge array and runs one
    ``np.cumsum`` (a strictly sequential left-to-right scan — the same
    rounding as the scalar chain); the sub-step machine charges the same
    components one scheduler event at a time.  Same floats, same order,
    every engine.
  * :meth:`DemandKernel.bill_demand_gets` is the demand-path Class B
    billing (integer counters — exact under any batching).

Deliberately import-free of the rest of ``repro``: the models are
duck-typed (``BucketModel``/``DiskModel``/``NetworkModel``/
``PipelineCostModel`` from ``repro.core.bandwidth``), so ``repro.core``
modules can import this one without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

#: Serving tiers a demand read can resolve to (step-granularity schedule).
DEMAND_TIERS = ("disk-source", "ram", "peer", "bucket")


@dataclasses.dataclass(frozen=True)
class DemandKernel:
    """Precomputed per-sample charge components for one node.

    Fields are the exact floats the node's scaled models produce for its
    workload's nominal sample size; ``sample_bytes`` rides along for
    billing.  Construct via :meth:`from_models` (full data plane) or
    :meth:`loop_only` (just the modelled training-loop overheads — the
    ``DeliLoader`` runtime mirror, where tier latencies come from the real
    stores sleeping their own clocks).
    """

    ram_hit_s: float
    cpu_overhead_s: float
    disk_get_s: float
    bucket_get_s: float
    peer_stream_s: float  # sub-step schedule: payload streaming after the RTT
    peer_transfer_s: float  # step schedule: RTT + streaming as one component
    probe_rtt_s: float  # failed peer probe (and the sub-step probe flight)
    sample_bytes: int

    @classmethod
    def from_models(cls, *, bucket, network, pipeline, sample_bytes: int, disk=None):
        """``disk=None`` is for consumers that can never serve from the
        disk-source tier (e.g. the sub-step machine, which only exists for
        bucket-source specs)."""
        return cls(
            ram_hit_s=pipeline.ram_hit_s,
            cpu_overhead_s=pipeline.cpu_overhead_s,
            disk_get_s=0.0 if disk is None else disk.get_seconds(sample_bytes),
            bucket_get_s=bucket.get_seconds(sample_bytes),
            peer_stream_s=network.stream_seconds(sample_bytes),
            peer_transfer_s=network.transfer_seconds(sample_bytes),
            probe_rtt_s=network.lookup_seconds(),
            sample_bytes=sample_bytes,
        )

    @classmethod
    def loop_only(cls, pipeline, sample_bytes: int = 0):
        """Just the modelled loop overheads (the runtime loader's share)."""
        return cls(
            ram_hit_s=pipeline.ram_hit_s,
            cpu_overhead_s=pipeline.cpu_overhead_s,
            disk_get_s=0.0,
            bucket_get_s=0.0,
            peer_stream_s=0.0,
            peer_transfer_s=0.0,
            probe_rtt_s=0.0,
            sample_bytes=sample_bytes,
        )

    def tier_charges(self, tier: str, probed: bool = False) -> Tuple[float, ...]:
        """The ordered charge components of one step-granularity access
        served by ``tier`` (training-loop CPU overhead excluded — every
        access charges ``cpu_overhead_s`` after these, on every engine).

        ``probed`` marks a bucket read preceded by a failed peer probe
        (peer tier present but nobody held the key): the probe RTT is
        charged before the GET, exactly the scalar engine's order.
        """
        if tier == "ram":
            return (self.ram_hit_s,)
        if tier == "peer":
            return (self.peer_transfer_s,)
        if tier == "disk-source":
            return (self.disk_get_s,)
        if tier == "bucket":
            if probed:
                return (self.probe_rtt_s, self.bucket_get_s)
            return (self.bucket_get_s,)
        raise ValueError(f"unknown demand tier {tier!r}; expected {DEMAND_TIERS}")

    def bill_demand_gets(self, store_stats, n: int = 1) -> None:
        """Bill ``n`` demand-path Class B GETs (integer counters: ``n``
        batched adds equal ``n`` repeated adds exactly, so the scalar and
        vector engines may call this per-sample or per-segment)."""
        store_stats.class_b_requests += n
        store_stats.bytes_read += n * self.sample_bytes
