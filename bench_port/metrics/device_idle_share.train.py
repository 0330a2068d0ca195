"""Share of the traced sub-window (a few training steps after the window,
from the first device operation's start to the last's end) in which no
operation ran on the device (torch.profiler)."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
