"""The port's copy of ``repro.obs.events``: the flight recorder's event
model and emit helpers, which the loader and the lock-step machinery call.
The ledger, the exporters and the trace-parity harness are not copied."""
from repro_torch.obs.events import (
    CLUSTER_NODE,
    CacheTracer,
    TraceEvent,
    TraceRecorder,
    canonical_stream,
    trace_demand,
    trace_emit,
    trace_sync,
)

__all__ = [
    "CLUSTER_NODE",
    "CacheTracer",
    "TraceEvent",
    "TraceRecorder",
    "canonical_stream",
    "trace_demand",
    "trace_emit",
    "trace_sync",
]
