"""Sample stores: the data sources DELI loads from.

Three implementations of one interface:

  * ``SimulatedBucketStore`` — an in-memory object store whose timing follows
    the calibrated ``BucketModel`` (this container has no cloud); request
    accounting (Class A/B) feeds the cost model.  This is the stand-in for
    GCS; the interface is the integration point for a real client.
  * ``FileSystemStore``      — real local files (the paper's disk baseline);
    can also *simulate* disk timing via ``DiskModel`` for deterministic
    benchmarks.
  * ``InMemoryStore``        — zero-latency store for unit tests.

``ReliableStore`` wraps any store with retry + exponential backoff and
hedged requests (issue a duplicate GET once the first exceeds a deadline) —
the fault-tolerance / straggler-mitigation layer required at pod scale,
where a 512-host job sees slow/failed GETs every step.
"""
from __future__ import annotations

import abc
import math
import os
import random
import threading
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.bandwidth import BucketModel, DiskModel
from repro_torch.core.clock import Clock, RealClock
from repro_torch.core.types import StoreStats


class StoreError(RuntimeError):
    pass


class SampleStore(abc.ABC):
    """Abstract sample source keyed by integer dataset index.

    Every store carries a ``clock`` (wall time by default); wrappers and
    services read it directly instead of duck-typing ``getattr(store,
    "clock")`` — it is part of the interface.
    """

    def __init__(self) -> None:
        self.stats = StoreStats()
        self.clock: Clock = RealClock()
        self._stats_lock = threading.Lock()

    @abc.abstractmethod
    def get(self, index: int) -> bytes:
        """Fetch one object (a Class B request for bucket stores)."""

    @abc.abstractmethod
    def size_of(self, index: int) -> int:
        """Object size in bytes without fetching (metadata)."""

    @abc.abstractmethod
    def list_objects(self) -> List[int]:
        """List all object indices (Class A request(s) for bucket stores)."""

    def __len__(self) -> int:
        return len(self.list_objects())

    def _account(self, *, a: int = 0, b: int = 0, nbytes: int = 0, seconds: float = 0.0) -> None:
        with self._stats_lock:
            self.stats.class_a_requests += a
            self.stats.class_b_requests += b
            self.stats.bytes_read += nbytes
            self.stats.read_seconds += seconds


class InMemoryStore(SampleStore):
    """Latency-free store for unit tests."""

    def __init__(self, payloads: Dict[int, bytes]):
        super().__init__()
        self._payloads = dict(payloads)

    def get(self, index: int) -> bytes:
        try:
            payload = self._payloads[index]
        except KeyError as e:
            raise StoreError(f"no object {index}") from e
        self._account(b=1, nbytes=len(payload))
        return payload

    def size_of(self, index: int) -> int:
        return len(self._payloads[index])

    def list_objects(self) -> List[int]:
        self._account(a=1)
        return sorted(self._payloads)


class SimulatedBucketStore(SampleStore):
    """GCS-bucket stand-in with Table-I-calibrated timing.

    ``get`` sleeps the modelled GET duration on the injected clock; with a
    scaled ``RealClock`` the ratios of the paper's experiments are preserved
    while tests run in milliseconds.  Thread-safe: concurrent ``get`` calls
    model independent connections (the thread pool's sub-linear scaling is
    applied by callers that know their fan-out, e.g. the pre-fetch service,
    via ``penalty``).
    """

    def __init__(
        self,
        payloads: Dict[int, bytes],
        model: Optional[BucketModel] = None,
        clock: Optional[Clock] = None,
        failure_rate: float = 0.0,
        seed: int = 0,
    ):
        super().__init__()
        self._payloads = dict(payloads)
        self.model = model or BucketModel()
        self.clock = clock or RealClock()
        self.failure_rate = failure_rate
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()

    def _maybe_fail(self) -> None:
        if self.failure_rate > 0.0:
            with self._rng_lock:
                r = self._rng.random()
            if r < self.failure_rate:
                raise StoreError("simulated transient bucket error (503)")

    def get(self, index: int, penalty: float = 1.0) -> bytes:
        """One GET. ``penalty`` >= 1 stretches the duration (shared NIC)."""
        try:
            payload = self._payloads[index]
        except KeyError as e:
            raise StoreError(f"no object {index}") from e
        dt = self.model.get_seconds(len(payload)) * penalty
        self._maybe_fail()
        self.clock.sleep(dt)
        self._account(b=1, nbytes=len(payload), seconds=dt)
        return payload

    def size_of(self, index: int) -> int:
        return len(self._payloads[index])

    def bulk_get(self, indices: Sequence[int], n_connections: int = 16) -> List[bytes]:
        """Parallel batch GET (what the pre-fetch service issues).

        GCS has no batch-download API (§II-B), so the service 'simulates a
        batch download by downloading multiple files in parallel' (§IV-C).
        Duration follows the calibrated sub-linear thread-pool model; one
        Class B request is billed per object.
        """
        payloads = []
        for i in indices:
            try:
                payloads.append(self._payloads[i])
            except KeyError as e:
                raise StoreError(f"no object {i}") from e
        self._maybe_fail()
        dt = self.model.bulk_get_seconds([len(p) for p in payloads], n_connections)
        self.clock.sleep(dt)
        self._account(b=len(payloads), nbytes=sum(len(p) for p in payloads), seconds=dt)
        return payloads

    def list_objects(self) -> List[int]:
        keys = sorted(self._payloads)
        pages = max(1, math.ceil(len(keys) / self.model.page_size))
        self.clock.sleep(self.model.list_seconds(len(keys)))
        self._account(a=pages)
        return keys


class FileSystemStore(SampleStore):
    """Local-disk store (the paper's disk baseline).

    With ``simulate_timing=True`` reads additionally sleep the DiskModel
    duration so benchmark ratios are deterministic on any machine.
    """

    def __init__(
        self,
        root: str,
        model: Optional[DiskModel] = None,
        clock: Optional[Clock] = None,
        simulate_timing: bool = False,
    ):
        super().__init__()
        self.root = root
        self.model = model or DiskModel()
        self.clock = clock or RealClock()
        self.simulate_timing = simulate_timing

    @staticmethod
    def path_for(root: str, index: int) -> str:
        return os.path.join(root, f"{index:08d}.bin")

    @classmethod
    def write_dataset(cls, root: str, payloads: Dict[int, bytes]) -> "FileSystemStore":
        os.makedirs(root, exist_ok=True)
        for i, p in payloads.items():
            with open(cls.path_for(root, i), "wb") as f:
                f.write(p)
        return cls(root)

    def get(self, index: int) -> bytes:
        path = self.path_for(self.root, index)
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except FileNotFoundError as e:
            raise StoreError(f"no object {index}") from e
        dt = self.model.get_seconds(len(payload)) if self.simulate_timing else 0.0
        if dt:
            self.clock.sleep(dt)
        self._account(b=1, nbytes=len(payload), seconds=dt)
        return payload

    def size_of(self, index: int) -> int:
        return os.path.getsize(self.path_for(self.root, index))

    def list_objects(self) -> List[int]:
        self._account(a=1)
        return sorted(
            int(name.split(".")[0]) for name in os.listdir(self.root) if name.endswith(".bin")
        )


class ReliableStore(SampleStore):
    """Retry + hedging wrapper: the data-plane fault-tolerance layer.

    * Transient ``StoreError``s are retried with exponential backoff
      (``base_backoff * 2**attempt``), up to ``max_attempts``.
    * Straggler mitigation: if a GET exceeds ``hedge_after_s`` the caller
      may issue a duplicate request ("request hedging", beyond-paper; in
      the threaded runtime this is realized by the pre-fetch service's
      per-request deadline — see prefetcher.py).  Here we count hedges.
    """

    def __init__(
        self,
        inner: SampleStore,
        max_attempts: int = 5,
        base_backoff_s: float = 0.01,
        clock: Optional[Clock] = None,
        on_retry: Optional[Callable[[int, Exception], None]] = None,
    ):
        super().__init__()
        self.inner = inner
        self.max_attempts = max_attempts
        self.base_backoff_s = base_backoff_s
        self.clock = clock or inner.clock
        self.on_retry = on_retry
        self.retries = 0
        self.hedges = 0

    def get(self, index: int, **kw) -> bytes:
        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            try:
                return self.inner.get(index, **kw) if kw else self.inner.get(index)
            except StoreError as e:  # transient class
                last = e
                self.retries += 1
                if self.on_retry:
                    self.on_retry(attempt, e)
                self.clock.sleep(self.base_backoff_s * (2.0**attempt))
        raise StoreError(f"GET {index} failed after {self.max_attempts} attempts: {last}")

    def size_of(self, index: int) -> int:
        return self.inner.size_of(index)

    def list_objects(self) -> List[int]:
        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            try:
                return self.inner.list_objects()
            except StoreError as e:
                last = e
                self.retries += 1
                self.clock.sleep(self.base_backoff_s * (2.0**attempt))
        raise StoreError(f"LIST failed after {self.max_attempts} attempts: {last}")

    @property
    def stats(self) -> StoreStats:  # type: ignore[override]
        return self.inner.stats

    @stats.setter
    def stats(self, v: StoreStats) -> None:
        # abc __init__ assigns; route to inner when present, else stash.
        if hasattr(self, "inner"):
            self.inner.stats = v
        else:
            self.__dict__["_pre_init_stats"] = v


def make_synthetic_payloads(
    n: int, sample_bytes: int, seed: int = 0
) -> Dict[int, bytes]:
    """Deterministic pseudo-random payloads (index-tagged for integrity checks)."""
    rng = random.Random(seed)
    out = {}
    for i in range(n):
        head = i.to_bytes(8, "little")
        body = rng.randbytes(max(0, sample_bytes - 8))
        out[i] = head + body
    return out
