"""Device milliseconds a traced batch spends in the program's
``model.moe.route`` spans (the router's product, its top-k, the sort of
the (token, expert) pairs by expert, the gather of their rows and the
per-expert counts read to the host), summed over the MoE layers, median
over the traced batches."""
import statistics


def read(run):
    try:
        from repro_torch.obs.spans import by_root
    except ImportError:  # a program without spans
        return None
    batches = [[e.attr("device_s") for e in b if e.kind == "model.moe.route"] for b in by_root("serve.generate")]
    batches = [b for b in batches if b]
    if not batches:
        return None
    return 1e3 * statistics.median(sum(b) for b in batches)
