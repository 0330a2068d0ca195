"""Clock abstraction: real, scaled, and virtual time.

The threaded pipeline runs against a ``Clock`` so that the *same* mechanism
code can run (a) in production against wall time, (b) in integration tests
against a scaled wall clock (simulated I/O durations shrunk by ``scale`` so a
"400 second" bucket epoch takes 40 ms of test time while preserving every
ratio the paper's results depend on), and (c) inside the discrete-event
simulator against pure virtual time.

Lock-step note (ISSUE 3): the lock-step runtime gives every node its own
``VirtualClock`` and sleeps the *same component sequence* the simulator
adds to its scalar time — each hop is one ``_t += seconds`` with identical
float operands, so the two timelines are bit-equal and the interleaved
cluster schedules coincide (docs/PARITY.md).  ``advance_to`` is the BSP
epoch-barrier primitive (monotonic jump, never backwards).
"""
from __future__ import annotations

import threading
import time
from typing import Protocol


class Clock(Protocol):
    def now(self) -> float: ...

    def sleep(self, seconds: float) -> None: ...


class RealClock:
    """Wall clock. ``scale`` < 1 shrinks simulated sleeps (I/O models only —

    never used to scale *measured* durations; measurements divide by scale
    to report virtual seconds)."""

    def __init__(self, scale: float = 1.0):
        if scale <= 0:
            raise ValueError("scale must be positive")
        self.scale = scale

    def now(self) -> float:
        return time.monotonic() / self.scale

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds * self.scale)


class VirtualClock:
    """Manually advanced clock for the discrete-event simulator.

    Thread-safe advance so the (single-threaded) simulator and property
    tests can share it; ``sleep`` advances time directly — there is no
    blocking in virtual time.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"cannot advance time backwards ({seconds})")
        with self._lock:
            self._t += seconds
            return self._t

    def advance_to(self, t: float) -> float:
        with self._lock:
            if t > self._t:
                self._t = t
            return self._t
