"""The port's observability: the flight recorder's event model (``events.py``,
the copy of ``repro.obs.events`` that the loader and the lock-step machinery
emit into) and the program's spans (``spans.py``), built on it.

To see where a job's time goes, profile any stretch of it with
``torch.profiler.profile``: while the profiler records, the training step,
its forward, backward and optimizer, each ``generate`` call, the model's
mixers and MLPs and the kernels' entries are spans.  Each but the kernels'
is a ``repro_torch::<name>`` range in the profiler's ``export_chrome_trace``,
beside the kernels it launched, and each is a ``TraceEvent`` that
``by_root`` and ``RECORDER.latest()`` return with its host and device times.
With no profiler recording a span costs a flag read.
"""
from repro_torch.obs.events import (
    CLUSTER_NODE,
    TraceEvent,
    TraceRecorder,
    trace_demand,
    trace_emit,
    trace_sync,
)
from repro_torch.obs.spans import RECORDER, SpanRecorder, by_root, leaf_span, span

__all__ = [
    "CLUSTER_NODE",
    "RECORDER",
    "SpanRecorder",
    "TraceEvent",
    "TraceRecorder",
    "by_root",
    "leaf_span",
    "span",
    "trace_demand",
    "trace_emit",
    "trace_sync",
]
