"""A prefill pool: ``ServeEngine.generate`` on batches of prompts of one
length, ``max_new_tokens`` 1, in a closed loop with one batch in flight.

Batch ``i``'s prompts are drawn uniformly from the vocabulary by
``numpy.random.default_rng((seed, 1, i))``, as the Python lists that
``generate`` takes.  The window's batches are drawn one ahead: batch
``i + 1`` as soon as batch ``i``'s prefill has been launched (batch 0 in
set-up), and batch ``i - 1``'s lists are freed there too, so that the
benchmark's own traffic generation runs while the device works and never
holds it idle between batches.  A request is due when its batch is sent,
and its first token is on the host when ``generate`` returns.  The pool
holds the decode caches that the prefill hands on for its last
``handoff_requests`` requests (the traffic file's), until decoders take
them: a queue of whole batches, the oldest dropped as each new batch
finishes.  Set-up draws the weights on the device from the seed, warms the
cell's one shape on two batches of their own and fills the queue with
copies of the second one's caches, standing for the requests prefilled
before the window.  The window sends batches until ``seconds`` have
passed, and at least ``keep_within`` of them (the limits file's), and
closes when the last one returns.

The check: once the window has closed and the port's state is freed, the
plain reference runs over a sample of the window's requests drawn from the
seed, which holds every request of one batch (also drawn from the seed)
whose last-position logits and decode caches the port handed on are kept
from the timed call itself.  Compared: the widest gap by which a served
token's reference logit lies below the reference's best, and for the kept
batch the relative L2 error of the logits (worst row) and of every layer's
cache at every position of the period (worst layer and block of
``reference_rows`` rows); a NaN anywhere reads NaN, which no limit
passes.  The kept batch is judged by the float32 reference; the other
sampled requests by the reference at the limits file's ``screen``
precision (float32, or bfloat16 products where float32 would make the
check outlast the window).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from bench_port import layouts
from bench_port.frozen.flops import prefill_flops
from bench_port.harness import Run, arch_config, free_device, profile, reference_class, start_device
from bench_port.reference.common import Precision, no_tf32, rel, worst
from bench_port.weights import make_weights, nest

WARMUP = 0
WINDOW = 1


def prompts(seed: int, stream: int, i: int, B: int, L: int, vocab: int) -> np.ndarray:
    return np.random.default_rng((seed, stream, i)).integers(0, vocab, size=(B, L), dtype=np.int64)


def copy_tree(tree):
    """A copy of a nest of dicts, lists and tuples of tensors, on their device."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(copy_tree(v) for v in tree)
    return tree


def run(spec, seed, seconds, trace, device, t_start, control=False) -> Run:
    import repro_torch.models.model as M
    from repro_torch.serving.engine import ServeEngine

    no_tf32()
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    run = Run(spec, device)
    run.mark("imports", t_start)
    start_device(device)
    run.mark("device", t_start)
    B, L, new = traffic["batch"], traffic["prompt_len"], traffic["max_new_tokens"]
    if new != 1:
        raise ValueError("the prefill driver times the first token: max_new_tokens must be 1")
    V = cfg["vocab"]
    flat = make_weights(cfg, seed, device)
    run.mark("weights", t_start)
    arch = arch_config(cfg)
    engine = ServeEngine(arch, M.DecoderLM(arch, nest(flat)), max_len=L + new, device=device)
    rng = np.random.default_rng((seed, 2))
    keep = int(rng.integers(0, limits["keep_within"]))  # the batch whose logits and caches are kept
    kept, current = {}, {"i": None}
    handoff = deque(maxlen=max(1, traffic["handoff_requests"] // B))  # caches waiting for a decoder
    upcoming, spent = [], []  # the next window batch's prompts, drawn ahead; the last one's, freed behind
    prefill = M.prefill

    def keeping_prefill(*args, **kwargs):
        out = prefill(*args, **kwargs)
        handoff.append(out[1][0])
        if current["i"] == keep:
            kept["logits"], kept["caches"] = out[0], out[1][0]
        if current["i"] is not None:  # launched: the device works on this batch while the host
            upcoming.append(prompts(seed, WINDOW, current["i"] + 1, B, L, V).tolist())  # draws the next
            spent.clear()  # and frees the last one's lists
        return out

    M.prefill = keeping_prefill
    try:
        for i in range(2):
            engine.generate(prompts(seed, WARMUP, i, B, L, V).tolist(), max_new_tokens=new)
            run.mark(f"warmup_batch{i + 1}", t_start)
        while len(handoff) < handoff.maxlen:
            handoff.append(copy_tree(handoff[-1]))
        if device == "cuda":
            torch.cuda.synchronize()
        upcoming.append(prompts(seed, WINDOW, 0, B, L, V).tolist())
        run.mark("handoff_filled", t_start)
        t0 = time.monotonic()
        run.setup_s = t0 - t_start
        deadline, i, served = t0 + seconds, 0, []
        flops = prefill_flops(cfg, B, L)
        while time.monotonic() < deadline or i < limits["keep_within"]:  # the kept batch is among them
            batch = upcoming.pop()
            current["i"] = i
            due = time.monotonic()
            res = engine.generate(batch, max_new_tokens=new)
            done = time.monotonic()
            spent.append(batch)
            served.append([t[0] for t in res.tokens])
            run.batches.append(dict(start=due, end=done, prompt_tokens=B * L, flops=flops))
            run.requests += [dict(batch=i, row=r, ttft_s=done - due, prompt_tokens=L) for r in range(B)]
            i += 1
        current["i"] = None
        run.window_s = run.batches[-1]["end"] - t0
        run.attempted = len(run.requests)
        if trace:
            extra = [prompts(seed, WARMUP, 2 + j, B, L, V).tolist() for j in range(traffic["profile_batches"])]
            profile(run, lambda: [engine.generate(p, max_new_tokens=new) for p in extra])
        if device == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        M.prefill = prefill
    del engine, handoff
    free_device(device)
    t_check = time.monotonic()
    judge(run, cfg, seed, device, flat, served, kept, keep, control)
    run.notes.append(f"the check took {time.monotonic() - t_check:.2f} s")
    return run


def judge(run, cfg, seed, device, flat, served, kept, keep, control) -> None:
    """The reference over the sampled requests in blocks of
    ``reference_rows``, the kept batch's first; with ``control`` also the
    control's readings (``run.readings``)."""
    traffic, limits = run.traffic, run.spec["limits"]
    B, L, V = traffic["batch"], traffic["prompt_len"], cfg["vocab"]
    rng = np.random.default_rng((seed, 3))
    others = [(b, r) for b in range(len(served)) for r in range(B) if b != keep]
    n_more = max(0, min(len(others), limits["sample_requests"] - B))
    pick = [(keep, r) for r in range(B)] + [others[j] for j in sorted(rng.choice(len(others), n_more, replace=False))]
    n = limits["reference_rows"]
    blocks = [pick[i : min(i + n, B)] for i in range(0, B, n)] + [pick[i : i + n] for i in range(B, len(pick), n)]
    Ref = reference_class(cfg)
    screen = Precision(limits.get("screen", "float32"))
    sides = {"program": None} | ({"control": Precision("fp8")} if control else {})
    nums = {side: dict(token_gap=0.0, logits_rel=0.0, cache_rel=0.0) for side in sides}
    for rows in blocks:
        first = rows[0][0] == keep  # rows of the kept batch: its logits and caches are compared too
        r0, r1 = rows[0][1], rows[-1][1] + 1
        toks = torch.from_numpy(np.stack([prompts(seed, WINDOW, b, B, L, V)[r] for b, r in rows])).to(device)
        ref_caches, ctl_caches = {}, {}
        ref = Ref(cfg, flat, None if first else screen).prefill(toks, collect(ref_caches) if first else None)
        best = ref.max(dim=-1).values
        for side, prec in sides.items():
            if side == "program":
                tokens = torch.tensor([served[b][r] for b, r in rows], device=device)
                logits = kept["logits"][r0:r1].float() if first else None
                caches = layer_caches(kept["caches"], len(layouts.positions(cfg)), r0, r1) if first else None
            else:
                logits = Ref(cfg, flat, prec).prefill(toks, collect(ctl_caches) if first else None)
                tokens, caches = logits.argmax(dim=-1), ctl_caches
            gap = float((best - ref.gather(1, tokens[:, None])[:, 0]).max())
            got = nums[side]
            got["token_gap"] = worst(got["token_gap"], gap)
            if first:
                if set(caches) != set(ref_caches):
                    raise ValueError(f"the {side}'s caches {sorted(caches)} are not the reference's {sorted(ref_caches)}")
                got["logits_rel"] = worst(got["logits_rel"], *(rel(logits[i], ref[i]) for i in range(len(rows))))
                got["cache_rel"] = worst(got["cache_rel"], *(rel(caches[key].float(), t) for key, t in ref_caches.items()))
        del ref_caches, ctl_caches
        free_device(device)
    for name, value in nums["program"].items():
        run.check(name, value, limits[name])
    run.readings = nums


def layer_caches(caches: dict, period: int, r0: int, r1: int) -> dict:
    """Rows ``r0:r1`` of the port's caches (``pos{i}`` -> name -> a tensor
    stacked over periods) by (absolute layer ``p * period + i``, name), the
    numbering of a reference's ``on_cache``."""
    out = {}
    for pos, entries in caches.items():
        i = int(pos[len("pos"):])
        for name, t in entries.items():
            for p in range(t.shape[0]):
                out[(p * period + i, name)] = t[p][r0:r1]
    return out


def collect(into: dict):
    """A reference's ``on_cache``: keeps each layer's cache entries by (layer, name)."""
    def on_cache(layer, entries):
        for name, t in entries.items():
            into[(layer, name)] = t
    return on_cache
