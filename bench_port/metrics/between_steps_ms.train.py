"""Host milliseconds from the end of one traced step's ``train.sync`` (the
loss on the host: the device has run out of work) to the start of the next
step's first ``train.forward``: the device's idle gap between steps, median
over consecutive pairs of traced steps.  None with fewer than two."""
import statistics


def read(run):
    try:
        from repro_torch.obs.spans import by_root
    except ImportError:  # a program without spans
        return None
    sync_end, forward_start = {}, {}
    for step in by_root("train.step"):
        n = step[0].attr("step")
        for e in step:
            if e.kind == "train.sync":
                sync_end[n] = e.t + e.dur
            elif e.kind == "train.forward":
                forward_start.setdefault(n, e.t)
    gaps = [forward_start[n + 1] - end for n, end in sync_end.items() if n + 1 in forward_start]
    if not gaps:
        return None
    return 1e3 * statistics.median(gaps)
