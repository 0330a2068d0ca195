"""Median of ``StepMetrics.compute_s`` over the window's steps: the step
from the call to the loss on the host, without the data wait."""
import statistics


def read(run):
    if not run.steps:
        return None
    return 1e3 * statistics.median(s["compute_s"] for s in run.steps)
