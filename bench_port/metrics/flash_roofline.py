"""The flash attention op's share of its roofline in the traced prefills:
the sum over its calls of the bound at the shapes it was handed (the
larger of FLOPs at 989e12/s and bytes at 3.35e12 B/s, ``frozen/roofline``)
over the device time of every kernel launched inside its entry."""
from bench_port.frozen.roofline import flash_bound_s

ENTRIES = ["repro_torch.kernels.ops:flash_attention"]


def read(run):
    calls = run.entry_calls.get("flash_attention")
    device_s = (run.profile or {}).get("ranges", {}).get("flash_attention", 0.0)
    if not calls or device_s <= 0:
        return None
    bound = 0.0
    for c in calls:
        (B, Sq, H, hd), (_, Sk, KV, _) = c["shapes"][0], c["shapes"][1]
        bound += flash_bound_s(B, Sq, Sk, H, KV, hd, c["dtype"], c["kwargs"].get("causal", True),
                               c["kwargs"].get("window"))
    return 100.0 * bound / device_s
