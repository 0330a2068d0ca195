"""Model FLOPs of the window's prefills (``frozen/flops.py``) over the
window, against the bf16 peak of one H100 (989 TFLOP/s)."""
from bench_port.frozen.roofline import PEAK_FLOPS


def read(run):
    if not run.batches:
        return None
    return 100.0 * sum(b["flops"] for b in run.batches) / run.window_s / PEAK_FLOPS["bfloat16"]
