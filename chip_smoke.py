#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases, each of which fails the run (non-zero exit, no result line) when
its check does not hold:

1. the card's name and power limit; TF32 switched off for f32 products;
2. build: every CUDA source of the port compiled by nvcc for sm_90a;
3. kernel against plain: the flash-attention kernel against its plain
   PyTorch version on the card, at the serving path's shape and a sweep of
   others, with the kernel's time, the plain version's, one PyTorch SDPA
   call's (the yardstick, never used by the port) and the card's bound;
4. serve h2o-danube-3-4b at full width from seeded random weights drawn on
   the card: f32 prefill through the kernel against the non-kernel path and
   prefill against step-by-step decode, then the main path — a bf16
   ``ServeEngine`` answering 4 prompts of 1024 tokens with 32 greedy tokens
   each — with the kernel's launch count read around it;
5. a profile of one prefill and one decode step (device busy share, the
   kernels that take the time);
6. one JSON line of the kernels, the nvidia-smi line, and the result line.

Imports nothing of JAX or the reference package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM dense peaks (NVIDIA data sheet, at the 700 W limit): bf16 tensor
# cores, f32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# Tolerances of the reference's kernel tests (tests/test_kernels.py) and of
# its model-level checks (tests/test_arch_smoke.py).
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MODEL_TOL = 2e-3

ARCH = "h2o-danube-3-4b"
SERVE_B, SERVE_L, SERVE_NEW = 4, 1024, 32
CHECK_B, CHECK_L, CHECK_STEPS = 2, 512, 8


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel against plain
# ---------------------------------------------------------------------------
def visible_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(q, k) pairs the masks leave visible: the work this input needs."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, q - window + 1) if window is not None else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def bound(B, Sq, Sk, H, KV, hd, dtype, causal, window):
    """Least time the card could take: 4·hd FLOPs per visible pair per
    (batch, head) at the dtype's peak, against q, k, v read once and o
    written once at the memory rate.  Returns (ms, "operations"|"bytes")."""
    flops = 4 * B * H * hd * visible_pairs(Sq, Sk, causal, window)
    nbytes = torch.finfo(dtype).bits // 8 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa(q, k, v, causal, window, mask):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


# name, B, S, H, KV, hd, dtype, causal, window
KERNEL_SHAPES = [
    ("serve prefill (main path)", SERVE_B, SERVE_L, 32, 8, 120, torch.bfloat16, True, 4096),
    ("danube past the window", 1, 6144, 32, 8, 120, torch.bfloat16, True, 4096),
    ("danube heads, ragged S, f32", 2, 1000, 32, 8, 120, torch.float32, True, None),
    ("hd=128, H=48/KV=8", 1, 2048, 48, 8, 128, torch.bfloat16, True, None),
    ("MHA", 1, 128, 4, 4, 64, torch.float32, True, None),
    ("GQA 4:1", 2, 256, 8, 2, 32, torch.float32, True, None),
    ("MQA", 1, 384, 6, 1, 16, torch.float32, True, None),
    ("MQA bf16", 1, 384, 6, 1, 16, torch.bfloat16, True, None),
    ("small S", 2, 96, 4, 2, 64, torch.bfloat16, True, None),
    ("window 16", 2, 256, 4, 2, 32, torch.float32, True, 16),
    ("window 64", 2, 256, 4, 2, 32, torch.float32, True, 64),
    ("window 100", 2, 256, 4, 2, 32, torch.float32, True, 100),
    ("padded S=200", 1, 200, 4, 4, 32, torch.float32, True, None),
    ("non-causal", 2, 128, 4, 4, 64, torch.float32, False, None),
]


def kernel_checks(fa) -> list:
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, B, S, H, KV, hd, dtype, causal, window in KERNEL_SHAPES:
        q, k, v = (
            torch.randn(B, S, n, hd, generator=g, device="cuda").to(dtype) for n in (H, KV, KV)
        )
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = KERNEL_TOL[dtype]
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= tol + tol * want.float().abs()).all().item())
        check(ok, f"kernel disagrees with plain at {name}: max abs err {err} (tol {tol})")
        mask = None
        if window is not None:
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window), 20)
        plain_ms = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window), 3
        )
        library_ms = time_ms(lambda: sdpa(q, k, v, causal, window, mask), 20)
        bound_ms, bound_by = bound(B, S, S, H, KV, hd, dtype, causal, window)
        row = dict(
            shape=name, B=B, S=S, H=H, KV=KV, hd=hd, dtype=str(dtype).replace("torch.", ""),
            causal=causal, window=window, max_abs_err=err, tol=tol, ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        )
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, out, want, diff, mask
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Serving at full width
# ---------------------------------------------------------------------------
def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> tuple:
    diff = (a.float() - b.float()).abs()
    return bool((diff <= tol + tol * b.float().abs()).all().item()), diff.max().item()


def serve_f32_checks(configs, M, fa) -> None:
    """f32 at full width: the kernel path against the non-kernel path, and
    prefill against token-by-token decode."""
    cfg = dataclasses.replace(configs.get(ARCH), dtype="float32")
    model = M.DecoderLM.from_config(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (CHECK_B, CHECK_L), generator=g, device="cuda")
    with torch.inference_mode():
        fa.flash_attention.launches = 0
        logits_k, _ = M.prefill(model, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        check(
            fa.flash_attention.launches == cfg.n_layers,
            f"f32 prefill launched the kernel {fa.flash_attention.launches} times, want {cfg.n_layers}",
        )
        logits_x, _ = M.prefill(model, dataclasses.replace(cfg, use_kernels=False), {"tokens": tokens})
        ok, err = close(logits_k, logits_x, MODEL_TOL)
        print(f"serve f32 B={CHECK_B} L={CHECK_L}: kernel vs plain prefill logits max abs err {err}")
        check(ok, f"f32 prefill logits: kernel path vs plain path differ by {err}")
        check(bool(torch.isfinite(logits_k).all()), "f32 prefill logits not finite")

        head = tokens[:, :CHECK_STEPS]
        logits_p, _ = M.prefill(model, cfg, {"tokens": head})
        state = M.init_decode_state(cfg, CHECK_B, CHECK_STEPS, device="cuda")
        for pos in range(CHECK_STEPS):
            logits_d, state = M.decode_step(model, cfg, head[:, pos : pos + 1], state, pos)
        ok, err = close(logits_p, logits_d, MODEL_TOL)
        print(f"serve f32: prefill of {CHECK_STEPS} vs {CHECK_STEPS} decode steps max abs err {err}")
        check(ok, f"f32 prefill vs decode logits differ by {err}")
        check(bool(torch.isfinite(logits_d).all()), "f32 decode logits not finite")
    del model
    torch.cuda.empty_cache()


def serve_main_path(configs, M, ServeEngine, fa) -> dict:
    """The main path: a bf16 ServeEngine on the card, counts around it."""
    cfg = configs.get(ARCH)
    model = M.DecoderLM.from_config(cfg, seed=0)  # the card, by default
    engine = ServeEngine(cfg, model, max_len=SERVE_L + SERVE_NEW)
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_L), generator=g, device="cuda").tolist()
    engine.generate(prompts, max_new_tokens=2)  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()

    fa.flash_attention.launches = 0
    res = engine.generate(prompts, max_new_tokens=SERVE_NEW)
    launches = fa.flash_attention.launches

    check(launches == cfg.n_layers, f"one prefill launched the kernel {launches} times, want {cfg.n_layers}")
    check(len(res.tokens) == SERVE_B and all(len(t) == SERVE_NEW for t in res.tokens),
          "wrong number of generated tokens")
    check(all(0 <= t < cfg.vocab for seq in res.tokens for t in seq), "token outside [0, vocab)")
    with torch.inference_mode():
        toks = torch.tensor(prompts, device="cuda")
        logits, (caches, _) = M.prefill(model, cfg, {"tokens": toks})
        check(tuple(logits.shape) == (SERVE_B, cfg.vocab), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "bf16 prefill logits not finite")
        check(tuple(caches["pos0"]["k"].shape) == (cfg.n_periods, SERVE_B, SERVE_L, cfg.n_kv_heads, cfg.head_dim),
              "cache shape")
    decode_tok_s = SERVE_B * (SERVE_NEW - 1) / res.decode_s
    stats = dict(
        arch=ARCH, dtype=cfg.dtype, batch=SERVE_B, prompt_len=SERVE_L, new_tokens=SERVE_NEW,
        prefill_s=res.prefill_s, decode_s=res.decode_s,
        prefill_tok_s=SERVE_B * SERVE_L / res.prefill_s, decode_tok_s=decode_tok_s,
        decode_ms_per_step=res.decode_s / (SERVE_NEW - 1) * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, flash_launches=launches,
    )
    print("serve " + json.dumps(stats), flush=True)
    profile_serve(M, model, cfg, toks)
    del model, engine
    torch.cuda.empty_cache()
    return stats


def profile_serve(M, model, cfg, toks) -> None:
    """Where the time goes: one prefill and one decode step, each timed
    bare on the host clock and then traced by torch.profiler for its device
    kernels.  Device busy share = kernel time / bare wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        logits, (caches, kv_len) = M.prefill(model, cfg, {"tokens": toks})
        caches = {p: {k: F.pad(v, (0, 0, 0, 0, 0, 8)) for k, v in sub.items()}
                  for p, sub in caches.items()}
        cur = torch.argmax(logits, -1)[:, None]
        steps = {
            "prefill": lambda: M.prefill(model, cfg, {"tokens": toks}),
            "decode_step": lambda: M.decode_step(model, cfg, cur, (caches, kv_len), SERVE_L),
        }
        for label, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            device_ms = sum(by_name.values())
            check(device_ms > 0, f"the profiler saw no device kernel in {label}")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            print("profile " + json.dumps(dict(
                step=label, wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms, kernels=len(by_name),
                top_ms={name[:70]: ms for name, ms in top},
            )), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch import ServeEngine, configs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}",
        flush=True,
    )

    t0 = time.monotonic()
    logs = _build.build()
    print(f"build: {_build.sources()} in {time.monotonic() - t0:.2f} s "
          f"({len(logs)} compiled now)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = kernel_checks(fa)
    serve_f32_checks(configs, M, fa)
    stats = serve_main_path(configs, M, ServeEngine, fa)

    main_row = rows[0]
    kernels = [dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:34", launches=stats["flash_launches"],
        max_abs_err=main_row["max_abs_err"], ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
    )]
    worst = max(r["max_abs_err"] / r["tol"] for r in rows)
    print(f"kernels: flash_attention ok on {len(rows)} shapes (worst err/tol {worst:.3f}), "
          f"{stats['flash_launches']} launches on the main path", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
