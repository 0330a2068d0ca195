"""Device milliseconds a traced training step spends in the program's
``train.backward`` spans (summed over the step's microbatches), median over
the traced steps.  None where the program records no such span."""
import statistics


def read(run):
    try:
        from repro_torch.obs.spans import by_root
    except ImportError:  # a program without spans
        return None
    steps = [[e.attr("device_s") for e in step if e.kind == "train.backward"] for step in by_root("train.step")]
    steps = [s for s in steps if s]
    if not steps:
        return None
    return 1e3 * statistics.median(sum(s) for s in steps)
