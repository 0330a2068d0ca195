"""The SSD scan's share of its roofline in the traced prefills: the sum
over its calls of the bound at the shapes it was handed, counted at the
configuration's chunk (``frozen/roofline``), over the device time of every
kernel launched inside its entry."""
from bench_port.frozen.roofline import ssd_bound_s

ENTRIES = ["repro_torch.kernels.ops:ssd_scan"]


def read(run):
    calls = run.entry_calls.get("ssd_scan")
    device_s = (run.profile or {}).get("ranges", {}).get("ssd_scan", 0.0)
    if not calls or device_s <= 0:
        return None
    Q = run.config["ssm_chunk"]
    bound = 0.0
    for c in calls:
        (B, S, H, P), (_, _, G, N) = c["shapes"][0], c["shapes"][3]
        bound += ssd_bound_s(B, S, H, P, G, N, Q, c["dtype"])
    return 100.0 * bound / device_s
