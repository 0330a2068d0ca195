"""Model FLOPs of the window's training steps (``frozen/flops.py``) over
the window, against the bf16 peak of one H100 (989 TFLOP/s)."""
from bench_port.frozen.roofline import PEAK_FLOPS


def read(run):
    if not run.steps:
        return None
    return 100.0 * sum(s["flops"] for s in run.steps) / run.window_s / PEAK_FLOPS["bfloat16"]
