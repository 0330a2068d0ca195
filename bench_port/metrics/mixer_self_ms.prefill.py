"""Device milliseconds a traced batch spends in the program's
``model.mixer`` spans (each attention or SSM block with its norm and
residual) less their ``kernel.*`` children: the mixers' own work beside the
hand kernels, median over the traced batches."""
import statistics


def read(run):
    try:
        from repro_torch.obs.spans import by_root
    except ImportError:  # a program without spans
        return None
    per_batch = []
    for batch in by_root("serve.generate"):
        mixers = {e.attr("id"): e.attr("device_s") for e in batch if e.kind == "model.mixer"}
        if not mixers:
            continue
        kernels = sum(e.attr("device_s") for e in batch if e.kind.startswith("kernel.") and e.attr("parent") in mixers)
        per_batch.append(sum(mixers.values()) - kernels)
    if not per_batch:
        return None
    return 1e3 * statistics.median(per_batch)
