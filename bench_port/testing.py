"""Toy-size cells for the CPU tests: each cell's configuration cut to two
periods of toy width (six layers of an SSM stack) and its traffic to a few
short rows, everything else (the driver, the check, the limits) as the
cell has it."""
from __future__ import annotations

import time

from bench_port import harness, layouts

TOY_DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, window=16)
TOY_SSM = dict(n_layers=6, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
TOY_MOE = dict(n_experts=4)
TOY_TRAIN = dict(batch=2, seq_len=32, n_samples=64, cache_items=8, profile_steps=1)
TOY_PREFILL = dict(batch=4, prompt_len=48, profile_batches=1, handoff_requests=8)
SEED = 2**31 + 12345  # past 32 signed bits: a run must take seeds that large


def toy_config(cfg: dict) -> dict:
    """The configuration at toy width, its pattern kept: the toy sizes of
    each kind of layer it has, two layers of a period of one position (six
    of an SSM stack), and two periods of a longer period."""
    pattern = layouts.positions(cfg)
    mixers = {m for m, _ in pattern}
    out = dict(cfg)
    if "attn" in mixers or any(c != "none" for _, c in pattern):
        out.update(TOY_DENSE)
    if "ssm" in mixers:
        out.update(TOY_SSM)
    if any(c == "moe" for _, c in pattern):
        out.update(TOY_MOE, top_k=min(cfg["top_k"], 2))
    if len(pattern) > 1:
        out["n_layers"] = 2 * len(pattern)
    return out


def toy_spec(workload: str, root: str = harness.ROOT) -> dict:
    spec = harness.load_cell(workload, root)
    cfg = toy_config(spec["config"])
    traffic = dict(spec["traffic"])
    traffic.update(TOY_TRAIN if traffic["kind"] == "train" else TOY_PREFILL)
    limits = dict(spec["limits"])
    if traffic["kind"] == "prefill":
        limits.update(sample_requests=8, reference_rows=2)
    return dict(spec, config=cfg, traffic=traffic, limits=limits)


def toy_run(workload: str, seconds: float = 0.5, trace: bool = False, control: bool = False,
            seed: int = SEED, root: str = harness.ROOT) -> harness.Run:
    """One run at toy size on one CPU thread, so that it does not crowd the
    other tests of a parallel run."""
    import torch

    spec = toy_spec(workload, root)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.driver(spec).run(spec, seed, seconds, trace, "cpu", time.monotonic(), control=control)
    finally:
        torch.set_num_threads(threads)
