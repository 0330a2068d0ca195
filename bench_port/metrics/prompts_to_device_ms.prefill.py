"""Host milliseconds a traced batch spends in the program's
``serve.prompts_to_device`` span (the prompts' tensor built from the
request lists and copied to the device), median over the traced batches."""
import statistics


def read(run):
    try:
        from repro_torch.obs.spans import by_root
    except ImportError:  # a program without spans
        return None
    batches = [[e.dur for e in b if e.kind == "serve.prompts_to_device"] for b in by_root("serve.generate")]
    batches = [b for b in batches if b]
    if not batches:
        return None
    return 1e3 * statistics.median(sum(b) for b in batches)
