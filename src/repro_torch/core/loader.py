"""DeliLoader: the drop-in data loader that glues sampler, cache, pre-fetch
service and store into mini-batches, and *measures* the paper's two metrics
(data-wait time, miss rate) while doing so.

The iteration protocol matches the paper's Fig. 1/2 data flow:

  Sampler wrapper (PrefetchPlanner) --announce round--> PrefetchService
  DataLoader --get(idx)--> CachingDataset --hit--> cache
                                           --miss--> bucket (no insert)

Every ``__iter__`` is one epoch; ``set_epoch`` reshuffles the distributed
partition exactly like the paper's experiments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.clock import Clock, RealClock
from repro_torch.core.dataset import CachingDataset
from repro_torch.core.lockstep import (
    STEP_BATCH_END,
    STEP_CONTINUE,
    BucketedBatchComm,
    SubstepAccess,
)
from repro_torch.core.policy import PrefetchConfig, PrefetchPlanner
from repro_torch.core.prefetcher import PrefetchService
from repro_torch.core.sampler import Sampler
from repro_torch.core.types import EpochStats
from repro_torch.engine.kernels import DemandKernel
from repro_torch.obs.events import TraceRecorder, trace_demand, trace_emit, trace_sync

#: Internal marker yielded by ``_sample_steps`` for a sub-step phase (a
#: time component that is its own scheduler event, not a finished sample).
_PHASE = object()


@dataclasses.dataclass
class Batch:
    """One mini-batch of raw payloads + its data-plane accounting."""

    indices: List[int]
    payloads: List[bytes]
    data_wait_s: float
    hits: int
    misses: int

    def stacked(self, decode: Callable[[bytes], np.ndarray]) -> np.ndarray:
        return np.stack([decode(p) for p in self.payloads])


class DeliLoader:
    def __init__(
        self,
        dataset: CachingDataset,
        sampler: Sampler,
        batch_size: int,
        config: PrefetchConfig,
        service: Optional[PrefetchService] = None,
        clock: Optional[Clock] = None,
        node: int = 0,
        drop_last: bool = True,
        planner_factory: Optional[Callable[[Sequence[int]], object]] = None,
        oracle_view=None,
        trace: Optional[TraceRecorder] = None,
    ):
        """``planner_factory`` overrides the knob-driven ``PrefetchPlanner``
        with a custom epoch-order -> planner construction — the oracle data
        plane (ISSUE 5) passes ``repro.oracle.planner.make_planner_factory``
        here, the SAME construction ``NodeSimulator.begin_epoch`` uses.
        ``oracle_view`` is this node's clairvoyant ``NodeAccessView``; the
        loader drives it (``begin_epoch`` per epoch, ``on_consume`` per
        sample) in lines mirrored against the simulator's, which is what
        keeps Belady eviction and clairvoyant prefetch parity-exact."""
        if config.enabled and service is None:
            raise ValueError("prefetching enabled but no PrefetchService given")
        if planner_factory is not None and service is None:
            raise ValueError("planner_factory issues fetch rounds; give a service")
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.config = config
        self.service = service
        self.planner_factory = planner_factory
        self.oracle_view = oracle_view
        self.clock = clock or RealClock()
        self.node = node
        # Flight recorder (ISSUE 10): observe-only; ``None`` makes every
        # emit a no-op and the schedule byte-identical to an untraced run.
        self._trace = trace
        self.drop_last = drop_last
        self.epoch_history: List[EpochStats] = []
        self._epoch = 0
        self._resume_cursor = 0  # sample offset within the epoch (checkpointing)
        # The epoch-in-progress stats object (set while _sample_steps runs,
        # kept after epoch finalization): the cluster scheduler's allreduce
        # barriers account blocked time into it via sync_to(), including
        # the epoch-end barrier that fires after the stepper is exhausted.
        self._active_stats: Optional[EpochStats] = None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.sampler.set_epoch(epoch)

    # -- checkpoint/restore of the data-plane cursor -------------------------
    def state_dict(self) -> dict:
        """Checkpoint the data-plane cursor AND the accumulated per-epoch
        stats, so a resumed run reports its full trajectory (the seed
        dropped ``epoch_history`` across restore)."""
        return {
            "epoch": self._epoch,
            "cursor": self._resume_cursor,
            "history": [dataclasses.asdict(s) for s in self.epoch_history],
        }

    def load_state_dict(self, state: dict) -> None:
        self.set_epoch(int(state["epoch"]))
        self._resume_cursor = int(state["cursor"])
        if "history" in state:
            self.epoch_history = [
                s if isinstance(s, EpochStats) else EpochStats(**s)
                for s in state["history"]
            ]
        # Pre-history checkpoints carry no trajectory: keep whatever this
        # loader already accumulated (documented reset-free behaviour).

    # -- per-sample core (shared by batch iteration + lock-step stepping) ----
    def _sample_steps(
        self,
        stats: EpochStats,
        pipeline_model=None,
        compute_per_batch_s: float = 0.0,
        substep: Optional[SubstepAccess] = None,
        overlap: Optional[BucketedBatchComm] = None,
    ):
        """Process the epoch sample-by-sample, yielding
        ``(index, AccessResult, data_wait_s, consumed, batch_end)`` after
        each access (``batch_end`` = this sample completed a gradient
        batch), with bare ``_PHASE`` markers in between at sub-step
        granularity.

        ``pipeline_model`` (a ``PipelineCostModel``) enables *modelled
        training-loop costs*: after each read, the clock additionally
        sleeps the RAM-hit latency (local-cache hits) and the per-sample
        CPU overhead — the exact components, in the exact order, that
        ``NodeSimulator._access`` adds to its virtual time, so a lock-step
        runtime's clock trajectory is float-identical to the simulator's.
        ``compute_per_batch_s`` likewise sleeps the modelled compute after
        every full batch (inside the step, exactly like the simulator).
        Both default off, preserving the free-running loader's behaviour of
        measuring only what the stores really charge.

        ``substep`` (a ``repro.core.lockstep.SubstepAccess``) replaces the
        tier-stack read with the shared sub-step state machine: each time
        component yields ``_PHASE`` so the cluster scheduler can interleave
        other nodes' events inside this access (mirroring the simulator's
        sub-step decomposition exactly — the machine IS the same object
        type running the same generator).

        ``overlap`` (a ``repro.core.lockstep.BucketedBatchComm``) replaces
        the single batch-end compute sleep with the bucketed compute/
        allreduce pipeline — each span boundary yields ``_PHASE`` exactly
        like a sub-step component, and only the exposed comm tail is
        charged (ISSUE 8; same generator the simulator runs).

        Mid-epoch resume (ISSUE 4 bugfix): gradient batches are a property
        of the epoch's *sample order*, not of the resume point — the batch
        counter starts at ``skip % batch_size`` so a cursor inside a batch
        completes that partial batch (and reaches its allreduce barrier) at
        the true epoch boundary instead of re-spanning a full batch from
        the resume point; and re-announced rounds are flagged ``replay``
        so the pre-fetch service skips the keys it already fetched — and
        billed — before the checkpoint (no re-issued Class B GETs, no
        re-billed per-round listing).
        """
        order = list(self.sampler)
        skip = self._resume_cursor
        self._resume_cursor = 0
        # The loader's share of the shared cost arithmetic
        # (repro.engine.kernels): tier latencies come from the real stores
        # sleeping their own clocks, so only the modelled loop overheads
        # are mirrored here — through the same kernel fields every engine
        # charges (bit-identical floats; see docs/PARITY.md).
        loop_kernel = (
            DemandKernel.loop_only(pipeline_model)
            if pipeline_model is not None
            else None
        )
        if self.oracle_view is not None:
            self.oracle_view.begin_epoch(self._epoch, order)
        planner = (
            self.planner_factory(order)
            if self.planner_factory is not None
            else PrefetchPlanner(order, self.config)
        )
        # Mirrored line (NodeSimulator.begin_epoch): a cluster-placement
        # planner carries the epoch's ownership set — install it on the
        # shared service, whose round partition enforces it identically on
        # both projections.
        owned = getattr(planner, "owned", None)
        if owned is not None and self.service is not None:
            self.service.set_placement(
                owned, in_flight=getattr(planner, "in_flight", None)
            )
        if self.service is not None:
            # Flight recorder: stamp the epoch's policy family on the shared
            # service so every issue event carries its provenance (the
            # simulator's begin_epoch stamps the identical line).
            self.service.provenance = getattr(planner, "provenance", "paper")
        consumed = 0
        in_batch = skip % self.batch_size
        self._active_stats = stats
        for idx, round_ in planner:
            replaying = consumed < skip
            if self.oracle_view is not None:
                # Cursor advances at access *start* (mirror of
                # NodeSimulator._epoch_events), replayed resumes included.
                self.oracle_view.on_consume(idx)
            if round_ is not None and self.service is not None:
                self.service.request(round_, stats=stats, replay=replaying)
            if replaying:
                consumed += 1
                continue  # resuming mid-epoch: rounds still announced above
            if substep is not None:
                for _ in substep.run(idx, stats):
                    yield _PHASE  # one time component = one scheduler event
                result = None
                dt = 0.0  # accounted inside the shared sub-step machine
                consumed += 1
            else:
                if self.service is not None:
                    # Lock-step completion barrier: fold prefetch rounds that
                    # finished by now (no-op for the free-running service).
                    self.service.advance_to(self.clock.now())
                t0 = self.clock.now()
                result = self.dataset.get(idx)
                if loop_kernel is not None:
                    if result.tier == "ram":
                        self.clock.sleep(loop_kernel.ram_hit_s)
                    self.clock.sleep(loop_kernel.cpu_overhead_s)
                dt = self.clock.now() - t0
                consumed += 1
                stats.samples += 1
                stats.record(result.tier)
                stats.data_wait_seconds += dt
                trace_demand(
                    self._trace,
                    self.node,
                    t0,
                    dt,
                    idx,
                    result.tier,
                    result.class_b,
                )
            in_batch += 1
            batch_end = False
            if in_batch == self.batch_size:
                in_batch = 0
                batch_end = True
                if overlap is not None:
                    for _ in overlap.run(stats):
                        yield _PHASE  # one bucket span = one scheduler event
                elif compute_per_batch_s:
                    c0 = self.clock.now()
                    self.clock.sleep(compute_per_batch_s)
                    stats.compute_seconds += compute_per_batch_s
                    trace_emit(
                        self._trace, "compute", self.node, c0, compute_per_batch_s
                    )
            yield idx, result, dt, consumed, batch_end

    def _finish_epoch(self, stats: EpochStats, evictions_before: int) -> None:
        if self.dataset.cache:
            stats.evictions = self.dataset.cache.stats.evictions - evictions_before
        self._resume_cursor = 0
        self.epoch_history.append(stats)

    def __iter__(self) -> Iterator[Batch]:
        stats = EpochStats(epoch=self._epoch, node=self.node)
        evictions_before = self.dataset.cache.stats.evictions if self.dataset.cache else 0
        batch_indices: List[int] = []
        batch_payloads: List[bytes] = []
        batch_wait = 0.0
        batch_hits = 0
        batch_misses = 0
        consumed = 0
        for idx, result, dt, consumed, _batch_end in self._sample_steps(stats):
            batch_wait += dt
            batch_indices.append(idx)
            batch_payloads.append(result.payload)
            if result.hit:
                batch_hits += 1
            else:
                batch_misses += 1
            if len(batch_indices) == self.batch_size:
                self._resume_cursor = consumed
                yield Batch(batch_indices, batch_payloads, batch_wait, batch_hits, batch_misses)
                batch_indices, batch_payloads = [], []
                batch_wait, batch_hits, batch_misses = 0.0, 0, 0
        if batch_indices and not self.drop_last:
            self._resume_cursor = consumed
            yield Batch(batch_indices, batch_payloads, batch_wait, batch_hits, batch_misses)
        self._finish_epoch(stats, evictions_before)

    def step_epoch(
        self,
        pipeline_model=None,
        compute_per_batch_s: float = 0.0,
        substep: Optional[SubstepAccess] = None,
        overlap: Optional[BucketedBatchComm] = None,
    ) -> Iterator[int]:
        """Event-granular epoch driver for a cluster scheduler.

        Each ``next()`` processes exactly one scheduler event — at step
        granularity a whole sample access (announcing its fetch round,
        folding due prefetch completions, reading through the tier stack,
        advancing the modelled loop costs), at sub-step granularity
        (``substep``) one virtual-time component of it — and yields a
        ``repro.core.lockstep`` signal: ``STEP_BATCH_END`` when the event
        completed a gradient batch (the ``sync="batch"`` parking point),
        else ``STEP_CONTINUE``.  An event-interleaved driver
        (``RuntimeCluster.run``) picks, after every event, whichever
        node's clock is earliest.  Exhausting the generator finalizes the
        epoch into ``epoch_history`` exactly like full-batch iteration.
        """
        stats = EpochStats(epoch=self._epoch, node=self.node)
        evictions_before = self.dataset.cache.stats.evictions if self.dataset.cache else 0
        for item in self._sample_steps(
            stats, pipeline_model, compute_per_batch_s, substep, overlap
        ):
            if item is _PHASE:
                yield STEP_CONTINUE
            else:
                yield STEP_BATCH_END if item[4] else STEP_CONTINUE
        self._finish_epoch(stats, evictions_before)

    def sync_to(self, t: float, comm_s: float = 0.0) -> None:
        """Allreduce barrier (lock-step cluster drive, ``sync="batch"``):
        account the blocked time into the epoch's stats, jump the node
        clock to the barrier, then serve the collective's transfer
        duration ``comm_s`` — the exact float operations
        ``NodeSimulator.sync_to`` performs, in the same order
        (``clock.sleep`` is the same ``+=`` the simulator applies)."""
        wait = t - self.clock.now()
        if wait > 0:
            if self._active_stats is not None:
                self._active_stats.allreduce_wait_seconds += wait
            self.clock.advance_to(t)
        if comm_s > 0:
            if self._active_stats is not None:
                self._active_stats.allreduce_comm_seconds += comm_s
            self.clock.sleep(comm_s)
        trace_sync(self._trace, self.node, self.clock.now(), wait, comm_s)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def last_epoch_stats(self) -> Optional[EpochStats]:
        return self.epoch_history[-1] if self.epoch_history else None


def run_epochs(
    loader: DeliLoader,
    epochs: int,
    compute_fn: Optional[Callable[[Batch], None]] = None,
    start_epoch: int = 0,
) -> List[EpochStats]:
    """Drive a loader for N epochs with an optional per-batch compute fn.

    ``compute_fn`` is where a training step goes; for pipeline-only
    experiments it simulates compute by sleeping on the loader's clock.
    """
    out: List[EpochStats] = []
    for e in range(start_epoch, start_epoch + epochs):
        loader.set_epoch(e)
        for batch in loader:
            if compute_fn is not None:
                compute_fn(batch)
        assert loader.last_epoch_stats is not None
        out.append(loader.last_epoch_stats)
    return out
