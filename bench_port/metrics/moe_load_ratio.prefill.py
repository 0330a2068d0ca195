"""The busiest expert's rows over the mean expert's, from the program's
``model.moe.route`` spans (their ``rows_max`` and ``rows_mean``, the
counts the dropless MoE reads to the host): averaged over the MoE layers
of a traced batch, median over the traced batches.  1 is an even load."""
import statistics


def read(run):
    try:
        from repro_torch.obs.spans import by_root
    except ImportError:  # a program without spans
        return None
    batches = [[e.attr("rows_max") / e.attr("rows_mean") for e in b
                if e.kind == "model.moe.route" and e.attr("rows_mean")] for b in by_root("serve.generate")]
    batches = [b for b in batches if b]
    if not batches:
        return None
    return statistics.median(statistics.fmean(b) for b in batches)
