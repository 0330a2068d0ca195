"""Share of the window's sample reads served by the local cache
(``StepMetrics`` hits over hits and misses)."""


def read(run):
    reads = sum(s["hits"] + s["misses"] for s in run.steps)
    if not reads:
        return None
    return 100.0 * sum(s["hits"] for s in run.steps) / reads
