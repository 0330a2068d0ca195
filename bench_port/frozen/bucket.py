"""The paper's Table-I bucket as a ``SampleStore`` of the benchmark's own.

Timing: a frozen copy of ``src/repro_torch/core/bandwidth.py::BucketModel``
(commit 3e2a384), itself calibrated to Table I: a GET of ``size`` bytes
takes ``request_latency + size / per_connection_bw`` (15.7 ms + size / 20
MB/s), and ``n`` GETs in flight together reach only ``n ** alpha`` times
one GET's rate (alpha = ln(281.73 / 49.80) / ln 16 = 0.626, at most 16
connections).  Here each GET sleeps in real time, stretched by
``n / n ** alpha`` for the ``n`` GETs in flight when it starts, so the
prefetcher's 16 threads see the calibrated sub-linear scaling.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

from repro_torch.core.store import SampleStore, StoreError

REQUEST_LATENCY_S = 784 / 49.80e3 - 784 / 20e6  # ~15.7 ms (Table I)
PER_CONNECTION_BW = 20e6  # bytes/s once a GET is streaming
PARALLEL_ALPHA = math.log(281.73 / 49.80) / math.log(16.0)  # ~0.626
MAX_CONNECTIONS = 16
LISTING_LATENCY_S = 0.050  # a page of a listing (Class A)
PAGE_SIZE = 1000


def get_seconds(size_bytes: int) -> float:
    """One GET alone."""
    return REQUEST_LATENCY_S + size_bytes / PER_CONNECTION_BW


def sharing_penalty(in_flight: int) -> float:
    """How much longer each of ``in_flight`` concurrent GETs takes than one
    alone: n GETs finish at n ** alpha times one GET's rate."""
    n = max(1, min(in_flight, MAX_CONNECTIONS))
    return n / n ** PARALLEL_ALPHA


class TableIBucket(SampleStore):
    """In-memory payloads served at Table-I timing, slept on the host clock."""

    def __init__(self, payloads: Dict[int, bytes]):
        super().__init__()
        self._payloads = payloads
        self._lock = threading.Lock()
        self._in_flight = 0

    def get(self, index: int, penalty: float = 1.0) -> bytes:
        try:
            payload = self._payloads[index]
        except KeyError as e:
            raise StoreError(f"no object {index}") from e
        with self._lock:
            self._in_flight += 1
            n = self._in_flight
        try:
            dt = get_seconds(len(payload)) * sharing_penalty(n) * penalty
            time.sleep(dt)
        finally:
            with self._lock:
                self._in_flight -= 1
        self._account(b=1, nbytes=len(payload), seconds=dt)
        return payload

    def size_of(self, index: int) -> int:
        return len(self._payloads[index])

    def list_objects(self) -> List[int]:
        keys = sorted(self._payloads)
        pages = max(1, math.ceil(len(keys) / PAGE_SIZE))
        time.sleep(pages * LISTING_LATENCY_S)
        self._account(a=pages)
        return keys
