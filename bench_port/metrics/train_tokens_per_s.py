"""Tokens of every training step of the window, over the window (its data
wait and the host's work between steps included)."""


def read(run):
    if not run.steps:
        return None
    return sum(s["tokens"] for s in run.steps) / run.window_s
