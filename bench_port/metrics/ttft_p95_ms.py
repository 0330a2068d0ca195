"""95th percentile over every request of the window of the time from when
it was due (its batch was sent) until its first token was on the host."""
import numpy as np


def read(run):
    if not run.requests:
        return None
    return float(np.percentile([r["ttft_s"] for r in run.requests], 95)) * 1e3
