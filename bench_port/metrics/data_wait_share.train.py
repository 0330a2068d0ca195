"""Share of the window the training loop spent waiting for its batches
(the sum of ``StepMetrics.data_wait_s`` of the window's steps)."""


def read(run):
    if not run.steps:
        return None
    return 100.0 * sum(s["data_wait_s"] for s in run.steps) / run.window_s
