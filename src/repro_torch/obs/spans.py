"""Spans: the port's named, nested intervals of work (a training step and its
forward, backward and optimizer; a ``generate`` call, its layers and its
kernels), recorded while a ``torch.profiler`` profile records and free
otherwise.

An operator profiles any stretch of a job, then reads the spans two ways::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(2)
    prof.export_chrome_trace("steps.json")  # repro_torch::<name> ranges beside the kernels
    for step in by_root("train.step"):      # the same spans, with device times
        for e in step:
            print(e.kind, e.dur, e.attr("device_s"))

``span(name, **attrs)`` is a context manager.  With no profiler recording it
is a shared null context: it opens no range, records no CUDA event and keeps
nothing.  While one records, a span

* opens ``torch.profiler.record_function("repro_torch::" + name)``, so it
  lies on the profiler's timeline, on the device trace's clock (a
  ``leaf_span`` opens none: the profiler gives a kernel to the innermost
  range open at its launch, so a range at the kernel's entry would take its
  kernels from a range that the entry's caller opened around the call);
* stamps its start and end on ``time.monotonic`` (the clock of the data
  plane's ``RealClock`` and of ``StepMetrics``);
* records a timing ``torch.cuda.Event`` at each end on the current stream
  where CUDA is in use, resolved into ``device_s`` only when the spans are
  read (on the CPU ``device_s`` is the host duration);
* takes an id, its parent's id (the innermost span open on its thread) and
  its root's id.  A span opened on a thread with none open, as autograd's
  backward threads are, is a child of the innermost span open on the thread
  that opened the newest root, while one is open: the recomputation inside
  a backward belongs to the step that runs it.

Each span ends as a ``TraceEvent`` (``kind`` the name, ``node`` the rank,
``t`` and ``dur`` on the host clock, attrs ``id``, ``parent`` (0 for a
root), ``root``, ``session`` and ``device_s`` beside the caller's) in one
process-wide ``SpanRecorder``, which keeps the newest ``CAPACITY`` of them.
A session is a stretch of spans recorded on with no span seen off and no
read between; the readers return the latest session's.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs.events import TraceEvent, TraceRecorder

PREFIX = "repro_torch::"
CAPACITY = 1 << 16

_OFF = contextlib.nullcontext()


class SpanRecorder(TraceRecorder):
    """The spans' sink: bounded, with each span's CUDA events kept until a
    reader asks for the spans and resolved then, outside the traced work."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        super().__init__()
        self.events = collections.deque(maxlen=capacity)
        self.unresolved = collections.deque(maxlen=capacity)  # ended spans whose device time is not read yet
        self.ids = itertools.count(1)
        self._local = threading.local()
        self.root_stack: List["_Span"] = []  # the open spans of the thread that opened the newest root
        self.session = 0
        self.seen_off = True  # a span was seen off, or the spans read, since the last span seen on

    def stack(self) -> List["_Span"]:
        """The spans open on the calling thread, outermost first."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def latest(self) -> List[TraceEvent]:
        """The latest session's spans, in the order they ended; the next
        span seen on starts a new session."""
        self.seen_off = True
        while self.unresolved:
            s = self.unresolved.popleft()
            if s.timing is None:
                device_s = s.dur
            else:
                start, end = s.timing
                end.synchronize()
                device_s = start.elapsed_time(end) / 1e3
            self.emit(s.name, s.node, s.t, s.dur, id=s.id, parent=s.parent, root=s.root,
                      session=s.session, device_s=device_s, **s.attrs)
        return [e for e in self.events if e.attr("session") == self.session]


RECORDER = SpanRecorder()


class _Span:
    __slots__ = ("name", "attrs", "ranged", "id", "parent", "root", "session", "node", "range", "timing", "t",
                 "dur")

    def __init__(self, name: str, attrs: Dict[str, Any], ranged: bool = True) -> None:
        self.name, self.attrs, self.ranged = name, attrs, ranged

    def __enter__(self) -> "_Span":
        rec = RECORDER
        if rec.seen_off:
            rec.seen_off = False
            rec.session += 1
        stack = rec.stack()
        outer: Optional[_Span] = stack[-1] if stack else (rec.root_stack[-1] if rec.root_stack else None)
        self.id, self.session = next(rec.ids), rec.session
        if outer is None:
            self.parent, self.root = 0, self.id
            rec.root_stack = stack
        else:
            self.parent, self.root = outer.id, outer.root
        stack.append(self)
        dist = torch.distributed
        self.node = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        self.range = torch.profiler.record_function(PREFIX + self.name) if self.ranged else _OFF
        self.range.__enter__()
        self.timing = None
        if torch.cuda.is_initialized():
            self.timing = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.timing[0].record()
        self.t = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.dur = time.monotonic() - self.t
        if self.timing is not None:
            self.timing[1].record()
        self.range.__exit__(*exc)
        RECORDER.stack().pop()
        RECORDER.unresolved.append(self)


def span(name: str, **attrs: Any):
    """A span named ``name`` while a torch profiler records; else a shared
    null context.  ``attrs`` (ints, floats, strings, flat tuples) go into
    its event."""
    if not _profiler._is_profiler_enabled:
        RECORDER.seen_off = True
        return _OFF
    return _Span(name, attrs)


def leaf_span(name: str, **attrs: Any):
    """``span`` without the profiler range, for the entry of a kernel (see
    the module's docstring)."""
    if not _profiler._is_profiler_enabled:
        RECORDER.seen_off = True
        return _OFF
    return _Span(name, attrs, ranged=False)


def by_root(kind: str) -> List[List[TraceEvent]]:
    """The latest session's spans under each root span named ``kind``: one
    list a root, the root first and then its descendants by start, the
    roots in the order they began."""
    events = sorted(RECORDER.latest(), key=lambda e: e.t)
    groups = {e.attr("id"): [e] for e in events if e.kind == kind and e.attr("parent") == 0}
    for e in events:
        group = groups.get(e.attr("root"))
        if group is not None and e.attr("parent") != 0:
            group.append(e)
    return list(groups.values())
