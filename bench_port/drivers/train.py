"""Training fed from a bucket: the port's ``Trainer`` on its DELI pipeline
(``make_lm_pipeline``) over the benchmark's Table-I bucket.

Set-up draws the dataset and the weights from the seed, builds one
``Trainer`` and drives it through its first steps with the window's own
call (``Trainer.train``), reading the gradient as the optimizer took it
after step 1 (its first moment over 1 - beta1) and the parameters' change
after step 3.  The window is one call, ``Trainer.train(n)``, with ``n`` the
steps that fit in ``seconds`` at the pace of steps 2 and 3 (one call, so
that the loader iterates on as a training job's does; a call a step would
start its iteration anew each step).  Every step counted lies wholly
inside the window, which closes when the call returns.  Once the
window has closed and the port's state is freed, the plain reference
follows the first three steps on the same rows.
"""
from __future__ import annotations

import time
from unittest import mock

import numpy as np
import torch

from bench_port.frozen.bucket import TableIBucket
from bench_port.frozen.flops import train_flops
from bench_port.frozen.payloads import make_lm_payloads
from bench_port.harness import Run, arch_config, free_device, profile, reference_class, start_device
from bench_port.reference.common import Precision, no_tf32, worst
from bench_port.reference.optim import AdamW
from bench_port.weights import leaf_slices, make_weights, nest

CHECK_STEPS = 3


def slice_norms(flat: dict, like: dict = None) -> dict:
    """Norm of every per-layer slice and whole leaf (f32), by port name;
    of ``flat - like`` where ``like`` is given."""
    names, vals = [], []
    other = dict(leaf_slices(like)) if like is not None else None
    for name, t in leaf_slices(flat):
        d = t.float() if other is None else t.float() - other[name].float()
        names.append(name)
        vals.append(torch.linalg.vector_norm(d))
    return dict(zip(names, torch.stack(vals).tolist()))


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref);
    NaN where a leaf reads NaN."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return worst(*(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names))


def reference_readings(cfg, traffic, seed, device, rows, prec: Precision) -> dict:
    """The reference's losses, first clipped gradient and change after
    ``len(rows)`` steps, from the seed's weights, on ``rows`` (one int64
    array (B, S + 1) a step)."""
    W = make_weights(cfg, seed, device)
    ref = reference_class(cfg)(cfg, W, prec)
    opt = AdamW(W, traffic["optimizer"])
    losses, grad = [], None
    for r in rows:
        t = torch.from_numpy(r).to(device)
        loss, grads = ref.loss_and_grads(t[:, :-1], t[:, 1:])
        g = opt.update(grads)
        if grad is None:
            grad = slice_norms(g)
        losses.append(loss)
        del grads, g
    del opt
    free_device(device)
    change = slice_norms(W, make_weights(cfg, seed, device))
    del W, ref
    free_device(device)
    return dict(losses=losses, grad=grad, change=change)


def moved(ref: dict) -> set:
    """Leaves the change is compared on: a leaf whose reference gradient is
    under a thousandth of the median leaf's moves by round-off alone."""
    med = float(np.median(list(ref["grad"].values())))
    return {n for n, g in ref["grad"].items() if g >= 1e-3 * med}


def compare(prog: dict, ref: dict) -> dict:
    return dict(
        loss_rel=worst(*(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))),
        grad_rel=worst_leaf(prog["grad"], ref["grad"]),
        change_rel=worst_leaf(prog["change"], ref["change"], moved(ref)),
    )


def run(spec, seed, seconds, trace, device, t_start, control=False) -> Run:
    no_tf32()
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    run = Run(spec, device)
    run.mark("imports", t_start)
    start_device(device)
    run.mark("device", t_start)
    payloads = make_lm_payloads(traffic["n_samples"], traffic["seq_len"], cfg["vocab"], seed)
    run.mark("payloads", t_start)
    prog, stepped = program(run, payloads, seed, seconds, trace, t_start)
    free_device(device)  # the port's state is gone with program()'s frame
    t_check = time.monotonic()

    # the rows each step received, against the dataset's own bytes
    per_epoch = traffic["n_samples"] // traffic["batch"]  # steps an epoch; an index may come once in each
    seen, wrong, repeated = set(), 0, 0
    for k, (idx, tokens, labels) in enumerate(stepped):
        for i, t, l in zip(idx, tokens, labels):
            row = np.frombuffer(payloads[i], dtype=np.int32)
            wrong += int(not (np.array_equal(t, row[:-1]) and np.array_equal(l, row[1:])))
            repeated += int((k // per_epoch, i) in seen)
            seen.add((k // per_epoch, i))
    rows = [np.stack([np.frombuffer(payloads[i], dtype=np.int32) for i in idx]).astype(np.int64)
            for idx, _, _ in stepped[:CHECK_STEPS]]
    run.check("rows_wrong", wrong, 0)
    run.check("rows_repeated", repeated, 0)
    ref = reference_readings(cfg, traffic, seed, device, rows, Precision())
    nums = compare(prog, ref)
    for name, value in nums.items():
        run.check(name, value, limits[name])
    left_out = sorted(set(ref["grad"]) - moved(ref))
    run.notes.append(f"the change is compared on {len(ref['grad']) - len(left_out)} of {len(ref['grad'])} leaves; "
                     f"left out: {left_out}")
    run.readings = dict(program=nums, leaves_left_out=left_out)
    run.notes.append(f"the check took {time.monotonic() - t_check:.2f} s")
    if control:
        ctl = reference_readings(cfg, traffic, seed, device, rows, Precision("fp8", straight_through=True))
        run.readings["control"] = compare(ctl, ref)
    return run


def program(run: Run, payloads, seed, seconds, trace, t_start):
    """The port's part of the run: set-up, the first steps' readings, the
    window and the traced steps.  Returns the readings and, for every step
    taken, its rows' indices and the inputs and labels it received (on the
    host)."""
    from repro_torch.core import PrefetchConfig
    from repro_torch.data import decode_tokens, make_lm_pipeline
    from repro_torch.models.model import DecoderLM
    from repro_torch.training.loop import Trainer, TrainerConfig
    from repro_torch.training.optimizer import OptSettings

    run.mark("port_imports", t_start)
    cfg, traffic, device = run.config, run.traffic, run.device
    B, S, n = traffic["batch"], traffic["seq_len"], traffic["n_samples"]
    loader, service, _ = make_lm_pipeline(
        n_samples=n, seq_len=S, vocab=cfg["vocab"], batch_size=B,
        cache_items=traffic["cache_items"], policy=PrefetchConfig.fifty_fifty(traffic["cache_items"]),
        store=TableIBucket(payloads), seed=seed,
    )
    run.mark("pipeline", t_start)
    flat = make_weights(cfg, seed, device)
    adopt = classmethod(lambda cls, c, seed=0, device=None, trainable=False: cls(c, nest(flat), trainable))
    with mock.patch.object(DecoderLM, "from_config", adopt):  # the benchmark's weights, not the port's draw
        trainer = Trainer(arch_config(cfg), loader, TrainerConfig(seq_len=S, batch_size=B, log_every=1 << 62),
                          decode_tokens, settings=OptSettings(**traffic["optimizer"]), device=device)
    del flat, adopt
    run.mark("trainer", t_start)

    fed = []  # (indices, tokens, labels) of every batch the loop turned into a step's input
    to_device = trainer._to_device_batch

    def recording_to_device(batch):
        out = to_device(batch)
        fed.append((list(batch.indices), out["tokens"], out["labels"]))
        return out

    trainer._to_device_batch = recording_to_device
    service.start()
    try:
        trainer.train(1)
        b1 = traffic["optimizer"]["beta1"]
        names = list(trainer.opt_state["m"])
        norms = torch.stack([torch.linalg.vector_norm(trainer.opt_state["m"][k]) for k in names])
        prog = dict(grad={k: v / (1 - b1) for k, v in zip(names, norms.tolist())})
        t_pace = time.monotonic()
        trainer.train(CHECK_STEPS - 1)
        pace = (time.monotonic() - t_pace) / (CHECK_STEPS - 1)  # seconds a step, host time between steps included
        p0 = dict(leaf_slices(make_weights(cfg, seed, device)))
        named = list(trainer.params.named_parameters())
        diffs = torch.stack([torch.linalg.vector_norm(p.float() - p0[k].float()) for k, p in named])
        prog["change"] = dict(zip([k for k, _ in named], diffs.tolist()))
        prog["losses"] = [m.loss for m in trainer.metrics[:CHECK_STEPS]]
        del p0, diffs, named
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()  # the peak of the port's steps, not of the readings above

        run.mark("first_steps", t_start)
        t0 = time.monotonic()
        run.setup_s = t0 - t_start
        n_window = int(round(seconds / pace))
        if n_window:
            trainer.train(n_window)
        run.window_s = time.monotonic() - t0
        flops = train_flops(cfg, B, S)
        run.steps = [
            dict(loss=m.loss, data_wait_s=m.data_wait_s, compute_s=m.compute_s, hits=m.hits,
                 misses=m.misses, tokens=B * S, flops=flops)
            for m in trainer.metrics[CHECK_STEPS:]
        ]
        run.attempted = len(run.steps)
        if trace:
            profile(run, lambda: trainer.train(traffic["profile_steps"]))
        if device == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        stepped = [(idx, t.cpu().numpy(), l.cpu().numpy()) for idx, t, l in fed[: len(trainer.metrics)]]
    finally:
        service.close()
    return prog, stepped
