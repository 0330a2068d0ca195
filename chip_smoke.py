#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases, each of which fails the run (non-zero exit, no result line) when
its check does not hold:

1. the card's name and power limit; TF32 switched off for f32 products;
2. build: every CUDA source of the port compiled by nvcc for sm_90a, all
   started together; ptxas's registers, shared memory and spills of each
   kernel (a spill in a tensor-core kernel fails the run), and the count of
   tensor-core instructions (HMMA, HGMMA) in the SASS of each tensor-core
   kernel's library, from ``cuobjdump -sass`` (none found, or no cuobjdump,
   fails the run);
3. kernels against plain: flash attention and the SSD scan, each through its
   dtype rule (bf16 to the tensor-core kernel, f32 to the CUDA-core kernel),
   against its plain PyTorch version on the card, at its serving path's
   shape and a sweep of others, with the kernel's time, for bf16 the
   CUDA-core kernel's time on the same inputs (``previous_ms``, timed in
   turns: new, old, old, new), the plain version's, one PyTorch call's where
   one computes the same function (SDPA for attention — with ``is_causal``
   and no mask unless the window bites, ``library_path`` says which — the
   yardstick, never used by the port; none for the SSD scan) and the card's
   bound; the SSD sweep also runs past the zoo's widths, as the Pallas
   kernel takes them: P 128 at N 128 (bf16, the tensor cores on two P
   tiles), P 128 at N 256 and P 80 at N 136 (bf16 and f32, the CUDA-core
   kernel on tiles of 64 rows, f32 held against the plain version in
   float64), each with its bound at the tile and at the chunk;
4. serve h2o-danube-3-4b at full width from seeded random weights drawn on
   the card: f32 prefill through the CUDA-core kernel against the non-kernel
   path and prefill against step-by-step decode, then its main path — a bf16
   ``ServeEngine`` answering 4 prompts of 1024 tokens with 32 greedy tokens
   each, 24 tensor-core flash launches and no other kernel per prefill —
   with every launch count read around it, and a profile of one prefill and
   one decode step (device busy share, the kernels that take the time);
5. the same for mamba2-130m at full width and full depth: f32 checks at
   2 x 1000 tokens and 8 tokens, then its main path — 8 prompts of 2048
   tokens with 64 greedy tokens each, 24 tensor-core SSD launches per
   prefill;
   then phi3.5-moe-42b-a6.6b (16 experts, top-2, MoE in every layer) at full
   width, cut to 24 layers to fit the card: f32 checks at 4 layers (kernel
   path against plain path at 2 x 512; prefill against decode at a capacity
   that drops no token), then its main path as danube's — 24 tensor-core
   flash launches and no SSD launch per prefill — and ``from_config``'s peak
   memory held within 2 GB of the weights' bytes; then the hybrid period:
   jamba's reduced config in f32 through both CUDA-core kernels (2 flash and
   14 SSD launches a prefill), logits and caches against the plain path and
   greedy tokens equal to the plain path's;
   then SSD chunk 256: one SSM layer of jamba-1.5-large at full width
   (0.407 B parameters, B 1 x S 8192), kernel path against plain path in
   f32 and bf16, one SSD launch a call (``ssm_block`` lines; the SSD sweep
   has rows at jamba's SSM shape, with the bound at the tile and at the
   chunk); then phi-3-vision-4.2b at full width and depth through the step
   builders the reference serves a VLM with: f32 checks at 4 layers (kernel
   path against plain path on prompts of 576 patch embeddings + 448
   tokens; prefill against decode after a patch prompt), then
   ``make_prefill_step`` on 4 such prompts of 1024 positions and 32 greedy
   ``make_decode_step`` steps (``serve`` line, 32 tensor-core flash launches
   a prefill); then hubert-xlarge at full width and depth: f32 checks at 4
   layers at S 1024 and at the ragged S 1000, then ``make_encoder_step`` on
   8 utterances of 1024 frames (``encode`` line, 48 non-causal tensor-core
   flash launches);
6. train h2o-danube-3-4b, after the serving models are freed: an f32 step at
   full width cut to 2 layers (B=1, S=1100: the attention pads its second KV
   chunk, the CE loss drops its 76-token tail) on the card against the same
   step on the CPU (loss, global grad norm, every updated parameter at
   2e-3); then the main path — the full model, bf16, 6 steps of ``Trainer``
   (batch 2 x 2048) fed by the port's DELI pipeline, with per-step loss and
   time, data-wait, tokens/s, MFU and peak memory (``train`` line), every
   hand-kernel count 0 (the reference trains without its Pallas kernels),
   a profile of one step (``profile`` line) and its two halves timed apart
   (``train_phases``: forward + backward, AdamW); then phi3.5-moe-42b-a6.6b
   the same way: an f32 step at full width cut to 1 layer (B 1 x S 256) on
   the card against the CPU, the routed indices of every router call
   compared first, then 6 bf16 ``Trainer`` steps at full width cut to 3 of
   32 layers; then phi3.5-moe's MoE block at full width (x of 4 x 1024)
   sharded over two gloo ranks on the one card (``run_ranks``, 8 experts a
   rank, the combine an ``all_reduce`` of CUDA tensors), f32 exactly equal
   to the local block in this process and bf16 exactly equal to the bf16
   sum of the two halves' bf16 partial sums (``moe_sharded`` line); after
   danube's ``train`` line, ``roofline``: ``launch/counting.py`` and
   ``launch/roofline.py::analyze`` over one step of the same cell (counted
   FLOPs, eager bytes, the roofline terms and ``bound_s`` beside the measured
   median step); after ``moe_sharded``, ``train_sharded``: the sharded f32
   train step on two gloo ranks of the one card (danube at full width cut to
   2 layers on data 2 x model 1, B 2 x S 512; phi3.5-moe at full width cut to
   1 layer on data 1 x model 2, B 1 x S 256), each rank's loss, global grad
   norm, gradient shards and updated shards against its slices of the
   one-process step on the card at 2e-3, with the c10d collectives that
   gather the shards and reduce the gradients (``gather``, ``reduce``),
   and danube cut to 2 layers again on data 1 x model 2, its attention
   heads and d_ff split over the two ranks (the tensor-parallel backward),
   with each rank's head product and CE on its V/2 vocabulary columns and
   its embedding lookup on V/2 rows where the model axis is 2 (the head
   columns and embedding rows each rank saw, checked and printed);
   after ``train_sharded``, ``tp_serve``: tensor-parallel serving on two
   gloo ranks of the card (mesh data 1 x model 2, each rank on half of the
   heads and d_ff): (a) danube f32 at full width cut to 2 layers,
   ``make_prefill_step`` on 2 x 512 then 8 greedy ``make_decode_step``
   steps, each rank's logits within 2e-3 of one process, its tokens equal,
   exactly 2 CUDA-core flash launches a prefill at q (2, 512, 16, 120) and
   k/v (2, 512, 4, 120); (b) danube bf16 at full width and depth, 4 x 1024
   then 8 steps, exactly 24 tensor-core flash launches a prefill at 16 / 4
   heads, the kernel against its plain version on its inputs at 2e-2, each
   rank's peak memory and wall ms; (c) one jamba SSM layer at full width,
   B 1 x S 8192, the SSD scan on 128 heads a rank, held against its plain
   version on its inputs, and the f32 layer within 2e-3 of one process
   (``tp_serve`` lines; the kernel sweeps have rows at a rank's shapes);
   in (a) and (b) each rank's head and embedding on its 16000 of danube's
   32000 vocabulary rows, the logit columns gathered by the steps (the
   head columns each rank saw, checked and printed); then on three gloo
   ranks of the card (mesh data 1 x model 3), attention whose heads the
   model axis does not divide: deepseek-coder-33b at full width, its 56
   query heads split 19 / 19 / 18 and each rank's core run once for each
   run of heads with one q-to-kv mapping (2 / 3 / 2 runs across its kv
   groups of 7), (d) f32 cut to 2 layers, 2 x 512 then 8 greedy steps,
   tokens equal to one process and logits within 2e-3, and (e) bf16 cut to
   8 of 62 layers, 4 x 1024 then 8 steps, tokens equal across the ranks;
   each rank's flash launches exactly its layers x its runs, each at its
   run's q / k shapes, each run of the first layer held against the plain
   version;
   the lm-100m example at
   its defaults (300 f32 steps), whose loss must fall; and a checkpoint
   round trip at lm-test size, bit for bit;
7. one JSON line of the kernel variants, the nvidia-smi line, and the result
   line.

Imports nothing of JAX or the reference package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM dense peaks (NVIDIA data sheet, at the 700 W limit): bf16 tensor
# cores, f32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# Tolerances of the reference's kernel tests (tests/test_kernels.py:12,106)
# and of its model-level checks (tests/test_arch_smoke.py).
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
MODEL_TOL = 2e-3


@dataclasses.dataclass(frozen=True)
class Path:
    """One model's serving path: the main path's batch, prompt length and
    new tokens, and the f32 checks' batch and prompt length; ``layers`` and
    ``check_layers`` cut the depth of the main path and of the f32 checks
    (None: the published depth)."""

    arch: str
    serve_b: int
    serve_l: int
    serve_new: int
    check_b: int
    check_l: int
    layers: Optional[int] = None
    check_layers: Optional[int] = None

    def config(self, configs, check: bool = False):
        cfg = configs.get(self.arch)
        if check:
            cfg = dataclasses.replace(cfg, dtype="float32")
        n = self.check_layers if check else self.layers
        return cfg if n is None else dataclasses.replace(cfg, n_layers=n)


DANUBE = Path("h2o-danube-3-4b", 4, 1024, 32, 2, 512)
MAMBA = Path("mamba2-130m", 8, 2048, 64, 2, 1000)  # 1000: padded to 1024 in the block
# phi3.5-moe at its published widths cut from 32 to 24 layers: 1.300 B
# parameters a layer (16 experts of 3 x 4096 x 6400) and 262.7 M in embed and
# head make 63.0 GB of bf16 weights at 24 layers, 84.1 GB at 32 (over the
# card's 80) and 73.3 GB at 28 (no room left for the allocator).  Its f32
# checks cut it to 4 layers (20.9 GB).
PHI = Path("phi3.5-moe-42b-a6.6b", 4, 1024, 32, 2, 512, layers=24, check_layers=4)
HYBRID = "jamba-1.5-large-398b"  # served on the card in its reduced config only
# phi-3-vision-4.2b at full width and depth: 4 prompts of 1024 positions,
# the first 576 a 24 x 24 CLIP grid of patch embeddings, the other 448 text,
# then 32 greedy decode steps; f32 checks at 4 layers, 2 x 1024 (serve_new
# counts decode steps here)
VLM = Path("phi-3-vision-4.2b", 4, 1024, 32, 2, 1024, check_layers=4)
VLM_DECODE_PREFIX = 600  # prefill against decode: 576 patches + 24 text, then 8 decode steps
# hubert-xlarge at full width and depth: 8 utterances of 1024 frames (about
# 20 s of audio each at 50 frames/s), encoded, no decode; f32 checks at 4
# layers at S 1024 and at the ragged S 1000
ENCODER = Path("hubert-xlarge", 8, 1024, 0, 2, 1024, check_layers=4)
ENCODER_RAGGED_L = 1000
# one SSM layer of jamba-1.5-large at full width (d 8192, d_inner 16384,
# 256 heads, conv dim 16640, 0.407 B parameters), B 1 x S 8192, chunk 256:
# the whole model does not fit one card (one 8-layer period is 88.1 GB in bf16)
JAMBA_SSM_B, JAMBA_SSM_S = 1, 8192
# tensor-parallel serving on two gloo ranks of the card, mesh data 1 x model
# 2 (tp_serve): (a) danube f32 at full width cut to 2 layers, 2 x 512 then 8
# greedy steps, held against one process; (b) danube bf16 at full width and
# depth, 4 x 1024 then 8 steps; (c) the jamba SSM layer above, on 128 heads
# a rank
TP_ARCH = "h2o-danube-3-4b"
TP_F32_LAYERS, TP_F32_B, TP_F32_S = 2, 2, 512
TP_BF16_B, TP_BF16_S = 4, 1024
TP_NEW = 8
TP_RANKS = 2
# then on three gloo ranks of the card, mesh data 1 x model 3, attention
# whose heads the model axis does not divide: deepseek-coder-33b at its
# published widths (d 7168, 56 q / 8 kv heads of 128, d_ff 19200, vocab
# 32256), its 56 heads split 19 / 19 / 18, each rank's crossing kv groups
# of 7 (2 / 3 / 2 runs of one q-to-kv mapping, one flash launch each);
# (d) f32 cut to 2 layers, 2 x 512 then 8 greedy steps, held against one
# process; (e) bf16 cut to 8 of 62 layers, 4 x 1024 then 8 steps (each rank
# builds the whole model before sharding it: 9.4 GB a rank at 8 layers)
TP_UNEVEN_ARCH = "deepseek-coder-33b"
TP_UNEVEN_RANKS = 3
TP_UNEVEN_BF16_LAYERS = 8
CHECK_STEPS = 8
# prefill against step-by-step decode at a capacity that drops no token:
# decode routes B tokens a step, prefill B*S (tests/test_serving.py:19)
NO_DROP_CAPACITY = 16.0
INIT_SLACK_BYTES = 2e9  # from_config's peak over the weights' own bytes


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


def roofline(flops: float, nbytes: float, dtype) -> tuple:
    """Least time the card could take for ``flops`` at the dtype's peak and
    ``nbytes`` at the memory rate.  Returns (ms, "operations"|"bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound(B, Sq, Sk, H, KV, hd, dtype, causal, window):
    """Flash attention: 4·hd FLOPs per visible pair per (batch, head),
    against q, k, v read once and o written once."""
    flops = 4 * B * H * hd * visible_pairs(Sq, Sk, causal, window)
    nbytes = torch.finfo(dtype).bits // 8 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    return roofline(flops, nbytes, dtype)


def ssd_bound(B, S, H, P, G, N, Q, dtype):
    """SSD scan: 2Q(QN + QP + 2NP) FLOPs per (batch, head, block of Q rows)
    — the C Bᵀ scores, the M x product, the C Sᵀ term and the state update
    — against x read and y written once, dt, B and C once per group and the
    final f32 state written once.  Q is the chunk for the reference's work,
    or the kernels' tile (a chunk over 128 runs as sub-tiles, which need
    fewer FLOPs than the whole chunk)."""
    flops = 2 * Q * (Q * N + Q * P + 2 * N * P) * B * H * (S // Q)
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * (B * S * H + B * H * P * N + 2 * H)
    return roofline(flops, nbytes, dtype)


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


def window_bites(S: int, window) -> bool:
    """Whether a sliding window hides any key a causal mask leaves visible."""
    return window is not None and window < S


def sdpa(q, k, v, causal, mask):
    """SDPA on the same function: the explicit mask only where the window
    bites (it keeps SDPA off its flash backend), else ``is_causal``."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if mask is None:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def causal_window_mask(S: int, window: int) -> torch.Tensor:
    pos = torch.arange(S, device="cuda")
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


def time_in_turns(new, old, iters: int) -> tuple:
    """(new ms, old ms), each the mean of two timings taken new, old, old,
    new, so drift on the card falls on both alike."""
    a = time_ms(new, iters)
    b = time_ms(old, iters)
    c = time_ms(old, iters)
    d = time_ms(new, iters)
    return (a + d) / 2, (b + c) / 2


# name, B, S, H, KV, hd, dtype, causal, window
KERNEL_SHAPES = [
    ("serve prefill (main path)", DANUBE.serve_b, DANUBE.serve_l, 32, 8, 120, torch.bfloat16, True, 4096),
    ("phi prefill (main path)", PHI.serve_b, PHI.serve_l, 32, 8, 128, torch.bfloat16, True, None),
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
    # phi-3-vision's prefill (MHA, hd 96) and hubert's encode (MHA, hd 80,
    # no causal mask): hd padded to 128 in the tensor-core kernel
    ("phi-3-vision prefill (main path)", VLM.serve_b, VLM.serve_l, 32, 32, 96, torch.bfloat16, True,
     None),
    ("hubert encode (main path)", ENCODER.serve_b, ENCODER.serve_l, 16, 16, 80, torch.bfloat16,
     False, None),
    ("hubert heads, ragged S, f32", 2, ENCODER_RAGGED_L, 16, 16, 80, torch.float32, False, None),
    # a rank's heads in tp_serve (model 2): danube's 32 / 8 heads halved
    ("tp_serve (b): a rank's prefill", TP_BF16_B, TP_BF16_S, 16, 4, 120, torch.bfloat16, True, 4096),
    ("tp_serve (a): a rank's prefill, f32", TP_F32_B, TP_F32_S, 16, 4, 120, torch.float32, True, 4096),
    # the runs of a rank's heads in tp_serve (model 3): deepseek's whole kv
    # groups of 7 (two of them), and a part of a group (rank 0's last 5)
    ("tp_serve (e): a run of 2 whole groups", TP_BF16_B, TP_BF16_S, 14, 2, 128, torch.bfloat16, True, None),
    ("tp_serve (e): a run of part of a group", TP_BF16_B, TP_BF16_S, 5, 1, 128, torch.bfloat16, True, None),
    ("tp_serve (d): a run of 2 whole groups, f32", TP_F32_B, TP_F32_S, 14, 2, 128, torch.float32, True, None),
]


def close(a: torch.Tensor, b: torch.Tensor, tol: float, atol: float = None) -> tuple:
    """(every element within atol abs + tol rel, max abs err, worst share of
    the allowance diff / (atol + tol·|b|), which is <= 1 where close);
    ``atol`` is ``tol`` unless given."""
    diff = (a.float() - b.float()).abs()
    share = (diff / ((tol if atol is None else atol) + tol * b.float().abs())).max().item()
    return share <= 1.0, diff.max().item(), share


def launched(fn, before: int, what: str) -> None:
    check(fn.launches == before + 1, f"{what}: {fn.__name__} did not launch exactly once")


def kernel_checks(fa) -> list:
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, B, S, H, KV, hd, dtype, causal, window in KERNEL_SHAPES:
        q, k, v = (
            torch.randn(B, S, n, hd, generator=g, device="cuda").to(dtype) for n in (H, KV, KV)
        )
        tc = dtype == torch.bfloat16  # the dtype rule (all these inputs are aligned)
        kern = fa.flash_attention_tc if tc else fa.flash_attention_cuda_core
        before = kern.launches
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        launched(kern, before, f"flash {name}")
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = KERNEL_TOL[dtype]
        ok, err, share = close(out, want, tol)
        check(ok, f"flash kernel disagrees with plain at {name}: max abs err {err} (tol {tol})")
        run = lambda: kern(q, k, v, causal=causal, window=window)  # noqa: E731
        prev_share = None
        if tc:
            def prev():
                return fa.flash_attention_cuda_core(q, k, v, causal=causal, window=window)

            ok, _, prev_share = close(prev(), want, tol)
            check(ok, f"the CUDA-core flash kernel disagrees with plain at {name} (bf16)")
            kernel_ms, previous_ms = time_in_turns(run, prev, 20)
        else:  # f32 runs on the CUDA-core kernel, unchanged: it is its own previous
            kernel_ms = previous_ms = time_ms(run, 20)
        plain_ms = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window), 3
        )
        mask = causal_window_mask(S, window) if window_bites(S, window) else None
        library_ms = time_ms(lambda: sdpa(q, k, v, causal, mask), 20)
        library_path = "mask" if mask is not None else ("is_causal" if causal else "no_mask")
        # the explicit mask where the window does not bite: the slower masked path, for comparison
        masked_ms = None
        if window is not None and mask is None:
            full = causal_window_mask(S, window)
            masked_ms = time_ms(lambda: sdpa(q, k, v, causal, full), 20)
            del full
        bound_ms, bound_by = bound(B, S, S, H, KV, hd, dtype, causal, window)
        row = dict(
            shape=name, B=B, S=S, H=H, KV=KV, hd=hd, dtype=str(dtype).replace("torch.", ""),
            causal=causal, window=window, variant=fa.TENSOR_CORE if tc else fa.CUDA_CORE,
            max_abs_err=err, tol=tol, tol_share=share, previous_tol_share=prev_share,
            ms=kernel_ms, previous_ms=previous_ms, plain_ms=plain_ms, library_ms=library_ms,
            library_path=library_path, library_mask_ms=masked_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, out, want, mask
    torch.cuda.empty_cache()
    return rows


# name, B, S, H, P, G, N, chunk, dtype, strided (x, B, C slices of one xBC)
SSD_SHAPES = [
    ("serve prefill (main path)", MAMBA.serve_b, MAMBA.serve_l, 24, 64, 1, 128, 128, torch.bfloat16, True),
    ("mamba width, S=1024, f32", 2, 1024, 24, 64, 1, 128, 128, torch.float32, False),
    ("100-token prompt: chunk 100", 2, 100, 24, 64, 1, 128, 100, torch.bfloat16, False),
    ("100-token prompt: chunk 100, f32", 2, 100, 24, 64, 1, 128, 100, torch.float32, False),
    ("8-token prompt: chunk 8", 2, 8, 24, 64, 1, 128, 8, torch.bfloat16, False),
    ("8-token prompt: chunk 8, f32", 2, 8, 24, 64, 1, 128, 8, torch.float32, False),
    ("minimal", 1, 64, 2, 16, 1, 16, 16, torch.float32, False),
    ("minimal bf16", 1, 64, 2, 16, 1, 16, 16, torch.bfloat16, False),
    ("grouped B/C", 2, 128, 4, 32, 2, 16, 32, torch.float32, False),
    ("grouped B/C bf16", 2, 128, 4, 32, 2, 16, 32, torch.bfloat16, False),
    ("odd heads", 1, 96, 3, 16, 1, 32, 32, torch.float32, False),
    ("odd heads bf16", 1, 96, 3, 16, 1, 32, 32, torch.bfloat16, False),
    ("strided x/B/C, f32", 2, 512, 24, 64, 1, 128, 128, torch.float32, True),
    # jamba-1.5-large's SSM at full width: 256 heads of P 64, one group of N
    # 128, chunk 256 (two sub-tiles of 128 in the kernels)
    ("jamba width, chunk 256", 1, 8192, 256, 64, 1, 128, 256, torch.bfloat16, True),
    ("jamba width, chunk 256, f32", 1, 8192, 256, 64, 1, 128, 256, torch.float32, False),
    # a rank's heads in tp_serve (c) (model 2): jamba's 256 halved
    ("tp_serve (c): a rank's jamba heads, chunk 256", 1, 8192, 128, 64, 1, 128, 256, torch.bfloat16, True),
    # past the zoo's widths, as the Pallas kernel takes them: P in tiles of 64
    # (both kernels), N 256 in tiles of 64 rows (the CUDA-core kernel, which
    # the rule picks for bf16 past N 128 too)
    ("wide heads: P 128, N 128", 2, 2048, 16, 128, 1, 128, 128, torch.bfloat16, True),
    ("wide: P 128, N 256", 2, 2048, 16, 128, 1, 256, 128, torch.bfloat16, True),
    ("wide: P 128, N 256, f32", 2, 2048, 16, 128, 1, 256, 128, torch.float32, False),
    ("ragged P tile: P 80, N 136", 1, 512, 4, 80, 1, 136, 128, torch.bfloat16, False),
    ("ragged P tile: P 80, N 136, f32", 1, 512, 4, 80, 1, 136, 128, torch.float32, False),
]
NO_LIBRARY_SSD = "none: no single PyTorch call computes the SSD scan"


def ssd_inputs(g, B, S, H, P, G, N, dtype, strided):
    """x, dt, A, B, C, D drawn like tests/test_kernels.py's SSD inputs; with
    ``strided``, x, B and C are slices of one (B, S, H·P + 2·G·N) tensor, as
    the model hands them over."""
    cdim = H * P + 2 * G * N
    if strided:
        xbc = torch.randn(B, S, cdim, generator=g, device="cuda").to(dtype)
        xr, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
        x, Bm, Cm = xr.reshape(B, S, H, P), Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N)
        check(not x.is_contiguous(), "strided case: x came out contiguous")
    else:
        x = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
        Bm, Cm = (torch.randn(B, S, G, N, generator=g, device="cuda").to(dtype) for _ in range(2))
    dt = F.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    D = torch.ones(H, device="cuda")
    return x, dt, A, Bm, Cm, D


def ssd_checks(ssd) -> list:
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for name, B, S, H, P, G, N, chunk, dtype, strided in SSD_SHAPES:
        args = ssd_inputs(g, B, S, H, P, G, N, dtype, strided)
        tc = ssd._variant_of(args[0], args[3], args[4]) == ssd.TENSOR_CORE  # the rule
        check(tc == (dtype == torch.bfloat16 and N <= ssd.N_TC_MAX), f"SSD {name}: the rule picked "
              f"{'tensor_core' if tc else 'cuda_core'}")
        kern = ssd.ssd_scan_tc if tc else ssd.ssd_scan_cuda_core
        before = kern.launches
        y, st = ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        launched(kern, before, f"SSD {name}")
        # f32 past N 128 against the plain version in float64: |y| reaches
        # hundreds there, and two f32 summation orders part by more than
        # 2e-4 where y cancels (tests/test_torch_ssd_chunk.py::exact_scan)
        exact = dtype == torch.float32 and N > ssd.N_TC_MAX
        want_y, want_st = ssd.ssd_scan_plain(*args, chunk=chunk,
                                             precision=torch.float64 if exact else torch.float32)
        tol = SSD_TOL[dtype]
        ok_y, err_y, share_y = close(y, want_y, tol)
        ok_s, err_s, share_s = close(st, want_st, tol)
        check(ok_y and ok_s, f"SSD kernel disagrees with plain at {name}: "
                             f"max abs err y {err_y}, state {err_s} (tol {tol})")
        f32_share = None
        if exact:  # the share against the f32 plain version, for the record
            fy, fst = ssd.ssd_scan_plain(*args, chunk=chunk)
            f32_share = max(close(y, fy, tol)[2], close(st, fst, tol)[2])
            del fy, fst
        run = lambda: kern(*args, chunk=chunk)  # noqa: E731
        prev_share = None
        if tc:
            prev = lambda: ssd.ssd_scan_cuda_core(*args, chunk=chunk)  # noqa: E731
            py, pst = prev()
            oy, sy = close(py, want_y, tol)[::2]
            os_, ss = close(pst, want_st, tol)[::2]
            check(oy and os_, f"the CUDA-core SSD kernel disagrees with plain at {name} (bf16)")
            prev_share = max(sy, ss)
            kernel_ms, previous_ms = time_in_turns(run, prev, 20)
        else:  # f32 runs on the CUDA-core kernel, unchanged: it is its own previous
            kernel_ms = previous_ms = time_ms(run, 20)
        plain_ms = time_ms(lambda: ssd.ssd_scan_plain(*args, chunk=chunk), 3)
        # the bound of the work the kernels do (sub-tiles of ``tile`` rows),
        # the smaller one; the reference's whole-chunk work beside it
        tile = ssd.ssd_tile(chunk, N)
        bound_ms, bound_by = ssd_bound(B, S, H, P, G, N, tile, dtype)
        bound_chunk_ms, bound_chunk_by = ssd_bound(B, S, H, P, G, N, chunk, dtype)
        row = dict(
            shape=name, B=B, S=S, H=H, P=P, G=G, N=N, chunk=chunk, tile=tile,
            dtype=str(dtype).replace("torch.", ""), strided=strided,
            variant=ssd.TENSOR_CORE if tc else ssd.CUDA_CORE,
            max_abs_err=max(err_y, err_s), max_abs_err_y=err_y, max_abs_err_state=err_s, tol=tol,
            tol_share=max(share_y, share_s), previous_tol_share=prev_share,
            plain_precision="float64" if exact else "float32", f32_plain_tol_share=f32_share,
            ms=kernel_ms, previous_ms=previous_ms, plain_ms=plain_ms, library_ms=None,
            library=NO_LIBRARY_SSD, bound_ms=bound_ms, bound_by=bound_by,
            bound_ms_at_chunk=bound_chunk_ms, bound_at_chunk_by=bound_chunk_by,
        )
        print("ssd_kernel " + json.dumps(row), flush=True)
        rows.append(row)
        del args, y, st, want_y, want_st
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Serving at full width
# ---------------------------------------------------------------------------
def zero_counts(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def prefill_counts(cfg) -> dict:
    """The launches one prefill must make: one flash launch per attention
    layer and one SSD launch per SSM layer, each through its dispatcher and
    the variant the dtype picks (bf16: tensor cores, f32: CUDA cores).
    Every kernel left out must not launch at all."""
    variant = "tc" if cfg.torch_dtype == torch.bfloat16 else "cuda_core"
    want = {}
    for mixer, family in (("attn", "flash_attention"), ("ssm", "ssd_scan")):
        n = cfg.n_periods * cfg.period.count(mixer)
        if n:
            want[family] = want[f"{family}_{variant}"] = n
    return want


def check_counts(arch: str, counts: dict, want: dict, what: str) -> None:
    for name, n in counts.items():
        check(n == want.get(name, 0), f"{arch} {what} launched {name} {n} times, want {want.get(name, 0)}")


def serve_f32_checks(configs, M, path: Path, kernels) -> dict:
    """f32 at full width: the kernel path against the non-kernel path, and
    prefill against token-by-token decode (at a capacity that drops no token
    for an MoE model).  Returns the launch counts of the f32 kernel-path
    prefill."""
    cfg = path.config(configs, check=True)
    model = M.DecoderLM.from_config(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (path.check_b, path.check_l), generator=g, device="cuda")
    with torch.inference_mode():
        zero_counts(kernels)
        logits_k, _ = M.prefill(model, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        f32_counts = read_counts(kernels)
        check_counts(path.arch, f32_counts, prefill_counts(cfg), "f32 prefill")
        logits_x, _ = M.prefill(model, dataclasses.replace(cfg, use_kernels=False), {"tokens": tokens})
        ok, err, _ = close(logits_k, logits_x, MODEL_TOL)
        print(f"serve {path.arch} f32 {cfg.n_layers} layers B={path.check_b} L={path.check_l}: "
              f"kernel vs plain prefill logits max abs err {err}", flush=True)
        check(ok, f"{path.arch} f32 prefill logits: kernel path vs plain path differ by {err}")
        check(bool(torch.isfinite(logits_k).all()), f"{path.arch} f32 prefill logits not finite")

        head = tokens[:, :CHECK_STEPS]
        dcfg = dataclasses.replace(cfg, capacity_factor=NO_DROP_CAPACITY)  # moves only MoE
        logits_p, _ = M.prefill(model, dcfg, {"tokens": head})
        state = M.init_decode_state(dcfg, path.check_b, CHECK_STEPS, device="cuda")
        for pos in range(CHECK_STEPS):
            logits_d, state = M.decode_step(model, dcfg, head[:, pos : pos + 1], state, pos)
        ok, err, _ = close(logits_p, logits_d, MODEL_TOL)
        print(f"serve {path.arch} f32: prefill of {CHECK_STEPS} vs {CHECK_STEPS} decode steps "
              f"max abs err {err}", flush=True)
        check(ok, f"{path.arch} f32 prefill vs decode logits differ by {err}")
        check(bool(torch.isfinite(logits_d).all()), f"{path.arch} f32 decode logits not finite")
    del model
    torch.cuda.empty_cache()
    return f32_counts


def cache_shapes(cfg, B: int, L: int) -> dict:
    """What one prefill of B x L tokens must leave in the decode caches, by
    period position: K and V for attention, state and conv tail for SSM."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    kv = (cfg.n_periods, B, L, cfg.n_kv_heads, cfg.head_dim)
    ssm = {
        "state": (cfg.n_periods, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": (cfg.n_periods, B, cfg.ssm_conv - 1, conv_dim),
    }
    return {f"pos{i}": {"k": kv, "v": kv} if mixer == "attn" else ssm
            for i, mixer in enumerate(cfg.period)}


def check_caches(arch: str, caches: dict, cfg, B: int, L: int) -> None:
    want = cache_shapes(cfg, B, L)
    got = {pos: {name: tuple(t.shape) for name, t in sub.items()} for pos, sub in caches.items()}
    check(got == want, f"{arch} caches {got}, want {want}")


def from_config_measured(M, cfg, **kw):
    """``DecoderLM.from_config`` with its peak memory over what was allocated
    before it, held within INIT_SLACK_BYTES of the weights' own bytes.
    Returns (model, peak bytes, weight bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = M.DecoderLM.from_config(cfg, seed=0, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    check(peak <= weights + INIT_SLACK_BYTES,
          f"{cfg.name} from_config peaked at {peak / 1e9:.3f} GB for {weights / 1e9:.3f} GB of weights")
    return model, peak, weights


def serve_main_path(configs, M, ServeEngine, path: Path, kernels) -> dict:
    """A main path: a bf16 ServeEngine on the card, counts around it."""
    cfg = path.config(configs)
    model, init_peak, weight_bytes = from_config_measured(M, cfg)  # the card, by default
    engine = ServeEngine(cfg, model, max_len=path.serve_l + path.serve_new)
    g = torch.Generator(device="cuda").manual_seed(3)
    B, L, NEW = path.serve_b, path.serve_l, path.serve_new
    prompts = torch.randint(0, cfg.vocab, (B, L), generator=g, device="cuda").tolist()
    engine.generate(prompts, max_new_tokens=2)  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()

    zero_counts(kernels)
    res = engine.generate(prompts, max_new_tokens=NEW)
    counts = read_counts(kernels)

    check_counts(path.arch, counts, prefill_counts(cfg), "main path (one prefill)")
    check(len(res.tokens) == B and all(len(t) == NEW for t in res.tokens),
          "wrong number of generated tokens")
    check(all(0 <= t < cfg.vocab for seq in res.tokens for t in seq), "token outside [0, vocab)")
    with torch.inference_mode():
        toks = torch.tensor(prompts, device="cuda")
        logits, (caches, _) = M.prefill(model, cfg, {"tokens": toks})
        check(tuple(logits.shape) == (B, cfg.vocab), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{path.arch} bf16 prefill logits not finite")
        check_caches(path.arch, caches, cfg, B, L)
    stats = dict(
        arch=path.arch, layers=cfg.n_layers, dtype=cfg.dtype, batch=B, prompt_len=L, new_tokens=NEW,
        weights_gb=weight_bytes / 1e9, from_config_peak_gb=init_peak / 1e9,
        prefill_s=res.prefill_s, decode_s=res.decode_s,
        prefill_tok_s=B * L / res.prefill_s, decode_tok_s=B * (NEW - 1) / res.decode_s,
        decode_ms_per_step=res.decode_s / (NEW - 1) * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
    )
    print("serve " + json.dumps(stats), flush=True)
    profile_serve(M, model, cfg, toks, path)
    del model, engine
    torch.cuda.empty_cache()
    return stats


def profile_once(fn, arch: str, label: str, top_n: int = 6) -> dict:
    """Where the time goes in one call of ``fn``, after a warm-up call: timed
    bare on the host clock, then traced by torch.profiler for its device
    kernels.  Device busy share = kernel time / bare wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}  # device ms by kernel name, cut to 70 characters
    names = set()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names.add(e.name)
            key = e.name[:70]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    check(device_ms > 0, f"the profiler saw no device kernel in {arch} {label}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    # cuBLAS/CUTLASS matrix products by their kernel names (nvjet: cuBLAS's
    # Hopper GEMMs; sm80_xmma_gemm / simt_sgemm: its f32 ones)
    gemm_ms = sum(ms for name, ms in by_name.items() if "gemm" in name or "nvjet" in name)
    row = dict(arch=arch, step=label, wall_ms=wall_ms, device_ms=device_ms,
               device_busy_share=device_ms / wall_ms, kernels=len(names), gemm_ms=gemm_ms,
               top_ms=dict(top))
    print("profile " + json.dumps(row), flush=True)
    return row


def profile_serve(M, model, cfg, toks, path: Path) -> None:
    """One prefill and one decode step through ``profile_once``."""
    from repro_torch.serving.engine import grow_kv

    with torch.inference_mode():
        logits, (caches, kv_len) = M.prefill(model, cfg, {"tokens": toks})
        caches = grow_kv(caches, 8)  # K/V only: SSM caches have no sequence axis
        cur = torch.argmax(logits, -1)[:, None]
        profile_once(lambda: M.prefill(model, cfg, {"tokens": toks}), path.arch, "prefill")
        decode = lambda: M.decode_step(model, cfg, cur, (caches, kv_len), path.serve_l)  # noqa: E731
        profile_once(decode, path.arch, "decode_step")
        dot_f32_branch_cost(M, decode, path.arch)


def dot_f32_branch_cost(M, decode, arch: str, turns: int = 10) -> None:
    """What ``_dot_f32``'s serving branch (a bare ``mm`` when no gradient is
    needed) saves against sending every product through ``_MmF32.apply``:
    one decode step each way, in turns, on the host clock."""
    from repro_torch.models import layers, ssm

    plain = layers._dot_f32

    def through_apply(x, w):
        if x.is_cuda and not (x.dtype == w.dtype == torch.float32):
            out = layers._MmF32.apply(x.reshape(-1, x.shape[-1]), w)
            return out.reshape(*x.shape[:-1], w.shape[-1])
        return plain(x, w)

    times = {"mm": [], "apply": []}
    try:
        for i in range(2 * turns):
            kind = ("mm", "apply")[i % 2]
            for mod in (layers, M, ssm):
                mod._dot_f32 = plain if kind == "mm" else through_apply
            torch.cuda.synchronize()
            t0 = time.monotonic()
            decode()
            torch.cuda.synchronize()
            times[kind].append((time.monotonic() - t0) * 1e3)
    finally:
        for mod in (layers, M, ssm):
            mod._dot_f32 = plain
    row = dict(arch=arch, step="decode_step", turns=turns,
               mm_ms=float(np.median(times["mm"])), apply_ms=float(np.median(times["apply"])),
               mm_ms_all=times["mm"], apply_ms_all=times["apply"])
    print("dot_f32_branch " + json.dumps(row), flush=True)


def serve_hybrid_smoke(configs, M, ServeEngine, kernels) -> dict:
    """The hybrid period on the card: jamba's reduced config (2 periods of 7
    SSM positions and 1 attention position, MLP and MoE channel mixers in
    turn) in f32 through both CUDA-core kernels.  The kernel-path prefill's
    logits and caches against the plain path's, and the greedy tokens of a
    ServeEngine on each path, which must be equal."""
    cfg = dataclasses.replace(configs.reduce_for_smoke(configs.get(HYBRID)), dtype="float32")
    plain = dataclasses.replace(cfg, use_kernels=False)
    want = prefill_counts(cfg)
    check(want == {"flash_attention": 2, "flash_attention_cuda_core": 2,
                   "ssd_scan": 14, "ssd_scan_cuda_core": 14}, f"{cfg.name}: period {cfg.period}")
    model = M.DecoderLM.from_config(cfg, seed=0, device="cuda")
    B, L, NEW = 4, 32, 16  # examples/serve_batched.py's batch
    g = torch.Generator(device="cuda").manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (B, L), generator=g, device="cuda")
    with torch.inference_mode():
        zero_counts(kernels)
        logits_k, (caches_k, _) = M.prefill(model, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        check_counts(cfg.name, read_counts(kernels), want, "f32 prefill")
        logits_x, (caches_x, _) = M.prefill(model, plain, {"tokens": tokens})
    ok, err, _ = close(logits_k, logits_x, MODEL_TOL)
    check(ok, f"{cfg.name} f32 prefill logits: kernel path vs plain path differ by {err}")
    check(bool(torch.isfinite(logits_k).all()), f"{cfg.name} prefill logits not finite")
    check_caches(cfg.name, caches_k, cfg, B, L)
    cache_err = 0.0
    for pos, sub in caches_k.items():
        for name, t in sub.items():
            ok, e, _ = close(t, caches_x[pos][name], MODEL_TOL)
            check(ok, f"{cfg.name} cache {pos}/{name}: kernel path vs plain path differ by {e}")
            cache_err = max(cache_err, e)
    prompts = tokens.tolist()
    zero_counts(kernels)
    res = ServeEngine(cfg, model, max_len=L + NEW).generate(prompts, max_new_tokens=NEW)
    counts = read_counts(kernels)
    check_counts(cfg.name, counts, want, "ServeEngine.generate (one prefill)")
    res_x = ServeEngine(plain, model, max_len=L + NEW).generate(prompts, max_new_tokens=NEW)
    check(res.tokens == res_x.tokens, f"{cfg.name} greedy tokens: kernel path {res.tokens}, "
                                      f"plain path {res_x.tokens}")
    row = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers, period=list(cfg.period),
               mlp_pattern=list(cfg.mlp_pattern), batch=B, prompt_len=L, new_tokens=NEW,
               logits_max_abs_err=err, caches_max_abs_err=cache_err, tokens_equal=True,
               prefill_s=res.prefill_s, decode_s=res.decode_s, launches=counts)
    print("serve_hybrid " + json.dumps(row), flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The SSD chunk of 256 at jamba's width, the VLM and the audio encoder
# ---------------------------------------------------------------------------
def jamba_ssm_block_check(configs, M, kernels) -> dict:
    """One SSM layer of jamba-1.5-large at full width, drawn on the card as
    the model draws it, B 1 x S 8192 (chunk 256): the kernel path against
    the plain path (the chunked SSD at chunk 256), one SSD launch a call.
    f32 is held at the model-level 2e-3, element by element.  bf16 needs
    more: the two paths round the SSD output to bf16 at other places (the
    kernel once after y + D·x, the chunked path per chunk), one bf16 step is
    2^-8 of a value, and the out projection sums 16384 such differences into
    each output.  So bf16 y is held at the reference's bf16 kernel tolerance
    (2e-2) of its largest magnitude (a logits-scale allowance); the state,
    f32 on both paths, element by element at 2e-2.  Returns the launch
    counts by dtype."""
    from repro_torch.kernels import ssd
    from repro_torch.models.ssm import ssm_block, ssm_param_shapes

    B, S = JAMBA_SSM_B, JAMBA_SSM_S
    out = {}
    for dtype, tol in (("float32", MODEL_TOL), ("bfloat16", SSD_TOL[torch.bfloat16])):
        cfg = dataclasses.replace(configs.get(HYBRID), dtype=dtype)
        g = torch.Generator(device="cuda").manual_seed(9)
        params = M._init_tree(g, torch.device("cuda"), ssm_param_shapes(cfg), cfg)
        n_params = sum(t.numel() for t in params.values())
        x = torch.randn(B, S, cfg.d_model, generator=g, device="cuda").to(cfg.torch_dtype)
        variant = "tc" if dtype == "bfloat16" else "cuda_core"
        want = {"ssd_scan": 1, f"ssd_scan_{variant}": 1}
        with torch.inference_mode():
            zero_counts(kernels)
            y_k, (st_k, _) = ssm_block(params, x, cfg)
            torch.cuda.synchronize()
            counts = read_counts(kernels)
            check_counts(f"{HYBRID} ssm_block", counts, want, f"{dtype} kernel path (one call)")
            y_x, (st_x, _) = ssm_block(params, x, dataclasses.replace(cfg, use_kernels=False))
            kernel_ms = time_ms(lambda: ssm_block(params, x, cfg), 3)
            plain_ms = time_ms(lambda: ssm_block(params, x, dataclasses.replace(cfg, use_kernels=False)), 3)
        check(bool(torch.isfinite(y_k).all()), f"{HYBRID} ssm_block {dtype}: y not finite")
        y_max = y_x.float().abs().max().item()
        ok, err, share = close(y_k, y_x, tol, tol * y_max if dtype == "bfloat16" else None)
        ok_s, err_s, share_s = close(st_k, st_x, tol)
        row = dict(arch=HYBRID, layer="ssm_block", dtype=dtype, params=n_params, batch=B, seq=S,
                   d_model=cfg.d_model, d_inner=cfg.d_inner, heads=cfg.ssm_heads,
                   conv_dim=cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state, chunk=cfg.ssm_chunk,
                   tile=ssd.ssd_tile(cfg.ssm_chunk), tol=tol, max_abs_err_y=err, tol_share_y=share,
                   y_atol="tol * y_max_abs" if dtype == "bfloat16" else "tol",
                   max_abs_err_state=err_s, tol_share_state=share_s, y_max_abs=y_max,
                   kernel_path_ms=kernel_ms,
                   plain_path_ms=plain_ms, launches=counts)
        print("ssm_block " + json.dumps(row), flush=True)
        check(ok and ok_s, f"{HYBRID} ssm_block {dtype}: kernel path vs plain path differ by "
                           f"{err} (y), {err_s} (state), tol {tol}")
        out[dtype] = counts
        del params, x, y_k, y_x, st_k, st_x
        torch.cuda.empty_cache()
    return out


def vlm_batch(cfg, B: int, L: int, seed: int) -> dict:
    """A VLM prompt: seeded random patch embeddings over the first
    ``n_frontend_tokens`` positions (one 24 x 24 CLIP grid), text tokens
    after them (their ids under the patches are overwritten)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, L), generator=g, device="cuda")
    patches = torch.randn(B, cfg.n_frontend_tokens, cfg.d_model, generator=g, device="cuda")
    return {"tokens": tokens, "patch_embeds": patches.to(cfg.torch_dtype)}


def vlm_f32_checks(configs, M, kernels) -> dict:
    """phi-3-vision in f32 at full width, 4 layers, through the step
    builders: the kernel path's prefill logits against the plain path's on
    2 prompts of 576 patches + 448 text tokens; then decode after a patch
    prompt — the prefill of 600 + 8 positions against the prefill of 600
    and 8 decode steps.  Returns the kernel-path prefill's launch counts."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.serving.engine import grow_kv

    cfg = VLM.config(configs, check=True)
    model = M.DecoderLM.from_config(cfg, seed=0, device="cuda")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    batch = vlm_batch(cfg, VLM.check_b, VLM.check_l, 2)
    zero_counts(kernels)
    logits_k, _ = prefill(model, batch)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    check_counts(VLM.arch, counts, prefill_counts(cfg), "f32 prefill")
    logits_x, _ = make_prefill_step(dataclasses.replace(cfg, use_kernels=False))(model, batch)
    ok, err, _ = close(logits_k, logits_x, MODEL_TOL)
    print(f"serve {VLM.arch} f32 {cfg.n_layers} layers B={VLM.check_b} L={VLM.check_l} "
          f"({cfg.n_frontend_tokens} patches): kernel vs plain prefill logits max abs err {err}", flush=True)
    check(ok, f"{VLM.arch} f32 prefill logits: kernel path vs plain path differ by {err}")
    check(bool(torch.isfinite(logits_k).all()), f"{VLM.arch} f32 prefill logits not finite")

    n0, toks = VLM_DECODE_PREFIX, batch["tokens"]
    logits_p, _ = prefill(model, {**batch, "tokens": toks[:, : n0 + CHECK_STEPS]})
    _, (caches, kv_len) = prefill(model, {**batch, "tokens": toks[:, :n0]})
    state = (grow_kv(caches, CHECK_STEPS), kv_len)
    for i in range(CHECK_STEPS):
        logits_d, state = decode(model, state, toks[:, n0 + i : n0 + i + 1], n0 + i)
    ok, err, _ = close(logits_p, logits_d, MODEL_TOL)
    print(f"serve {VLM.arch} f32: prefill of {n0 + CHECK_STEPS} vs prefill of {n0} and "
          f"{CHECK_STEPS} decode steps max abs err {err}", flush=True)
    check(ok, f"{VLM.arch} f32 prefill vs decode logits differ by {err}")
    check(bool(torch.isfinite(logits_d).all()), f"{VLM.arch} f32 decode logits not finite")
    del model
    torch.cuda.empty_cache()
    return counts


def vlm_main_path(configs, M, kernels) -> dict:
    """phi-3-vision's main path at full width and depth, bf16: the
    reference's route for a VLM (its ServeEngine feeds tokens only) —
    ``make_prefill_step`` on 4 prompts of 576 patches + 448 text tokens,
    then 32 greedy ``make_decode_step`` steps, counts read around both."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.serving.engine import grow_kv

    cfg = VLM.config(configs)
    model, init_peak, weight_bytes = from_config_measured(M, cfg)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    B, L, steps = VLM.serve_b, VLM.serve_l, VLM.serve_new
    batch = vlm_batch(cfg, B, L, 3)
    prefill(model, batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts(kernels)
    t0 = time.monotonic()
    logits, (caches, kv_len) = prefill(model, batch)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    check(tuple(logits.shape) == (B, cfg.vocab), f"{VLM.arch} logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{VLM.arch} bf16 prefill logits not finite")
    check_caches(VLM.arch, caches, cfg, B, L)
    state = (grow_kv(caches, steps), kv_len)
    tok = torch.argmax(logits, -1)[:, None]
    generated = [tok]
    torch.cuda.synchronize()
    t2 = time.monotonic()
    for i in range(steps):
        logits_d, state = decode(model, state, tok, L + i)
        tok = torch.argmax(logits_d, -1)[:, None]
        generated.append(tok)
    torch.cuda.synchronize()
    t3 = time.monotonic()
    counts = read_counts(kernels)
    check_counts(VLM.arch, counts, prefill_counts(cfg), "main path (one prefill, decode steps)")
    check(bool(torch.isfinite(logits_d).all()), f"{VLM.arch} bf16 decode logits not finite")
    gen = torch.cat(generated, dim=1)
    check(bool(((gen >= 0) & (gen < cfg.vocab)).all()), "token outside [0, vocab)")
    prefill_s, decode_s = t1 - t0, t3 - t2
    stats = dict(
        arch=VLM.arch, layers=cfg.n_layers, dtype=cfg.dtype, batch=B, prompt_len=L,
        patch_positions=cfg.n_frontend_tokens, decode_steps=steps, route="make_prefill_step/make_decode_step",
        weights_gb=weight_bytes / 1e9, from_config_peak_gb=init_peak / 1e9,
        prefill_s=prefill_s, prefill_tok_s=B * L / prefill_s, decode_s=decode_s,
        decode_ms_per_step=decode_s / steps * 1e3, decode_tok_s=B * steps / decode_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
    )
    print("serve " + json.dumps(stats), flush=True)
    with torch.inference_mode():
        profile_once(lambda: prefill(model, batch), VLM.arch, "prefill")
        cur = torch.argmax(logits, -1)[:, None]
        profile_once(lambda: decode(model, (state[0], kv_len), cur, L), VLM.arch, "decode_step")
    del model, state, caches
    torch.cuda.empty_cache()
    return stats


def frames(cfg, B: int, S: int, seed: int) -> dict:
    """Seeded random frame embeddings (the reference stubs the conv feature
    extractor), in the model dtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, S, cfg.d_model, generator=g, device="cuda")
    return {"frame_embeds": x.to(cfg.torch_dtype)}


def encoder_f32_checks(configs, M, kernels) -> dict:
    """hubert in f32 at full width, 4 layers, through ``make_encoder_step``:
    per-frame logits of the kernel path (the CUDA-core flash kernel without
    the causal mask) against the plain path at S 1024 and at the ragged S
    1000.  Returns the launch counts by S."""
    from repro_torch.launch.steps import make_encoder_step

    cfg = ENCODER.config(configs, check=True)
    model = M.DecoderLM.from_config(cfg, seed=0, device="cuda")
    encode = make_encoder_step(cfg)
    plain = make_encoder_step(dataclasses.replace(cfg, use_kernels=False))
    out = {}
    for S in (ENCODER.check_l, ENCODER_RAGGED_L):
        batch = frames(cfg, ENCODER.check_b, S, 4)
        zero_counts(kernels)
        logits_k = encode(model, batch)
        torch.cuda.synchronize()
        out[S] = read_counts(kernels)
        check_counts(ENCODER.arch, out[S], prefill_counts(cfg), f"f32 encode S={S}")
        logits_x = plain(model, batch)
        check(tuple(logits_k.shape) == (ENCODER.check_b, S, cfg.vocab), f"logits {tuple(logits_k.shape)}")
        check(bool(torch.isfinite(logits_k).all()), f"{ENCODER.arch} f32 logits not finite")
        ok, err, _ = close(logits_k, logits_x, MODEL_TOL)
        print(f"encode {ENCODER.arch} f32 {cfg.n_layers} layers B={ENCODER.check_b} S={S}: "
              f"kernel vs plain per-frame logits max abs err {err}", flush=True)
        check(ok, f"{ENCODER.arch} f32 S={S} logits: kernel path vs plain path differ by {err}")
    del model
    torch.cuda.empty_cache()
    return out


def encoder_main_path(configs, M, kernels) -> dict:
    """hubert's main path at full width and depth, bf16: ``make_encoder_step``
    on 8 utterances of 1024 frames, counts read around it."""
    from repro_torch.launch.steps import make_encoder_step

    cfg = ENCODER.config(configs)
    model, init_peak, weight_bytes = from_config_measured(M, cfg)
    encode = make_encoder_step(cfg)
    B, S = ENCODER.serve_b, ENCODER.serve_l
    batch = frames(cfg, B, S, 5)
    encode(model, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.monotonic()
    logits = encode(model, batch)
    torch.cuda.synchronize()
    encode_s = time.monotonic() - t0
    counts = read_counts(kernels)
    check_counts(ENCODER.arch, counts, prefill_counts(cfg), "main path (one encode)")
    check(tuple(logits.shape) == (B, S, cfg.vocab), f"{ENCODER.arch} logits {tuple(logits.shape)}")
    check(logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
          f"{ENCODER.arch} bf16 per-frame logits not finite f32")
    stats = dict(
        arch=ENCODER.arch, layers=cfg.n_layers, dtype=cfg.dtype, batch=B, frames=S,
        route="make_encoder_step", weights_gb=weight_bytes / 1e9, from_config_peak_gb=init_peak / 1e9,
        encode_s=encode_s, frames_per_s=B * S / encode_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
    )
    print("encode " + json.dumps(stats), flush=True)
    profile_once(lambda: encode(model, batch), ENCODER.arch, "encode")
    del model, logits
    torch.cuda.empty_cache()
    return stats


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "h2o-danube-3-4b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 6
# the f32 check: 2 layers (the only cut), B=1, S=1100 — 2 KV chunks of 1024
# with padding, and a CE loss over 2 chunks of 512 that drops 76 tokens
CHECK_TRAIN_LAYERS, CHECK_TRAIN_S = 2, 1100
# phi3.5-moe: the f32 check at full width and 1 layer (1.56 B parameters,
# about 25 GB of weights, gradients and moments on each side), B 1 x S 256;
# the main path cut from 32 to 3 layers (4.16 B parameters: bf16 weights and
# gradients with f32 moments are 50 GB; 4 layers would be 66 GB before
# activations and the optimizer's temporaries)
MOE_TRAIN_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_CHECK_LAYERS, MOE_CHECK_S = 1, 256
MOE_TRAIN_LAYERS = 3


def train_batch(vocab: int, B: int, S: int, seed: int, device) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, vocab, (B, S + 1), generator=g, device="cuda").to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_memory_gb() -> dict:
    """The host's RAM and this process's peak resident set, in GB."""
    import resource

    with open("/proc/meminfo") as f:
        info = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    return dict(host_ram_gb=info["MemTotal"] / 1e9, host_available_gb=info["MemAvailable"] / 1e9,
                host_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9)


class RoutingRecorder:
    """Wraps ``moe.router_probs`` while in use: every call's routed indices
    (on the host) and its smallest top-k margin, the k-th largest router
    probability less the (k+1)-th, across the tokens."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        orig, moe = self.moe.router_probs, self.moe

        def recording(x_flat, router_w, top_k):
            idx, w = orig(x_flat, router_w, top_k)
            with torch.no_grad():
                top = torch.topk(torch.softmax(moe._dot_f32(x_flat, router_w), -1), top_k + 1).values
                self.calls.append((idx.detach().cpu(), (top[:, top_k - 1] - top[:, top_k]).min().item()))
            return idx, w

        self.orig, self.moe.router_probs = orig, recording
        return self

    def __exit__(self, *exc):
        self.moe.router_probs = self.orig


def train_f32_check(configs, kernels, arch: str = TRAIN_ARCH, layers: int = CHECK_TRAIN_LAYERS,
                    seq: int = CHECK_TRAIN_S) -> dict:
    """One f32 training step at full width (cut to ``layers``) on the card
    against the same step on the CPU, the path tier-1 holds against JAX: the
    step ``make_train_step`` runs, taken in its two halves
    (``loss_and_grads``, then ``adamw_update``) so the gradients can be read
    between them.  For an MoE model the routed indices of every router call
    (forward and recompute) are compared first: a near-tie that routes a
    token apart on the two sides fails the run, with the smallest top-k
    margin printed.

    Held at 2e-3: the loss, the global grad norm, every gradient leaf (to
    2e-3 of the leaf's largest magnitude, plus 2e-3 relative), every
    parameter after the step, and the update itself, p_after - p_before (to
    2e-3·lr, plus 2e-3 relative), against the CPU's update on the card's
    gradients.  The update is not held against the CPU's own update: AdamW's
    first step moves each element by about ±lr whatever its gradient's size,
    so an element whose gradient is near 0 takes the sign of its rounding;
    the share of elements where the two updates differ past the allowance is
    printed instead."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.model import DecoderLM
    from repro_torch.training.optimizer import OptSettings, _global_norm, adamw_init, adamw_update
    from repro_torch.weights import params_from_reference, params_to_numpy

    cfg = dataclasses.replace(configs.get(arch), n_layers=layers, dtype="float32")
    settings = OptSettings.auto(cfg.param_count())
    lr = settings.lr
    gpu = DecoderLM.from_config(cfg, seed=0, device="cuda", trainable=True)
    init = params_to_numpy(gpu)
    cpu = params_from_reference(init, cfg, "cpu", trainable=True)
    out, grads, deltas, routed = {}, {}, {}, {}
    zero_counts(kernels)
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        batch = train_batch(cfg.vocab, 1, seq, 5, name)
        opt = adamw_init(model, settings)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        t0 = time.monotonic()
        with RoutingRecorder(moe) as rec:
            loss, g = loss_and_grads(model, cfg, batch)
        routed[name] = rec.calls
        gnorm = _global_norm(g.values())
        adamw_update(model, g, opt, settings)
        out[name] = (loss.item(), gnorm.item(), time.monotonic() - t0)
        grads[name] = {n: t.detach().cpu() for n, t in g.items()}
        deltas[name] = {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()}
        del opt, before, g
    counts = read_counts(kernels)
    check(not any(counts.values()), f"the f32 training check launched hand kernels: {counts}")
    row = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, batch=1, seq=seq)
    if "moe" in cfg.mlp_pattern:
        n = len(routed["cuda"])
        check(n > 0 and n == len(routed["cpu"]), f"router calls: {n} on the card, {len(routed['cpu'])} on the CPU")
        flips = sum(int((a != b).any(dim=-1).sum()) for (a, _), (b, _) in zip(routed["cuda"], routed["cpu"]))
        row.update(router_calls=n, routed_equal=flips == 0, tokens_routed_apart=flips,
                   smallest_topk_margin=min(m for _, m in routed["cuda"] + routed["cpu"]))
        if flips:
            print("train_check " + json.dumps(row), flush=True)
            fail(f"f32 train step: {flips} tokens routed apart on the card and the CPU "
                 f"(smallest top-k margin {row['smallest_topk_margin']})")
    # the CPU's update on the card's gradients, from the same weights
    ref = params_from_reference(init, cfg, "cpu", trainable=True)
    del init
    before = {n: p.detach().clone() for n, p in ref.named_parameters()}
    adamw_update(ref, grads["cuda"], adamw_init(ref, settings), settings)
    ref_delta = {n: p.detach() - before[n] for n, p in ref.named_parameters()}
    del before
    (l_g, n_g, s_g), (l_c, n_c, s_c) = out["cuda"], out["cpu"]
    worst = dict(params=0.0, grads=0.0, update=0.0)
    outside = 0  # elements whose update differs from the CPU's own past the allowance
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        ok, err, share = close(a.detach().cpu(), b.detach(), MODEL_TOL)
        check(ok, f"f32 train step: parameter {name} differs between card and CPU by {err}")
        worst["params"] = max(worst["params"], share)
        gc = grads["cpu"][name]
        scale = max(gc.abs().max().item(), torch.finfo(torch.float32).tiny)
        ok, err, share = close(grads["cuda"][name], gc, MODEL_TOL, MODEL_TOL * scale)
        check(ok, f"f32 train step: gradient of {name} differs between card and CPU by {err} "
                  f"(largest magnitude {scale})")
        worst["grads"] = max(worst["grads"], share)
        ok, err, share = close(deltas["cuda"][name], ref_delta[name], MODEL_TOL, MODEL_TOL * lr)
        check(ok, f"f32 train step: the update of {name} differs from the CPU's on the same "
                  f"gradients by {err} (lr {lr})")
        worst["update"] = max(worst["update"], share)
        d_c = deltas["cpu"][name]
        outside += int(((deltas["cuda"][name] - d_c).abs() > MODEL_TOL * lr + MODEL_TOL * d_c.abs()).sum())
    for what, a, b in (("loss", l_g, l_c), ("global grad norm", n_g, n_c)):
        check(abs(a - b) <= MODEL_TOL * (1 + abs(b)), f"f32 train step: {what} {a} on the card, {b} on the CPU")
    check(all(np.isfinite([l_g, n_g])), "f32 train step: loss or grad norm not finite")
    n_elems = sum(p.numel() for p in cpu.parameters())
    row.update(loss_card=l_g, loss_cpu=l_c, grad_norm_card=n_g, grad_norm_cpu=n_c,
               params_worst_tol_share=worst["params"], grads_worst_tol_share=worst["grads"],
               update_worst_tol_share=worst["update"],
               update_vs_cpu_update_outside_share=outside / n_elems,
               step_s_card=s_g, step_s_cpu=s_c, params=n_elems, **host_memory_gb())
    print("train_check " + json.dumps(row), flush=True)
    del gpu, cpu, ref, grads, deltas, ref_delta
    torch.cuda.empty_cache()
    return row


def train_main_path(configs, kernels, card: str, arch: str = TRAIN_ARCH,
                    layers: Optional[int] = None) -> dict:
    """The main path: the model at full width (cut to ``layers``), bf16,
    ``Trainer`` on the port's DELI pipeline, counts read around it; then a
    profile of one step."""
    from repro_torch.core import PrefetchConfig
    from repro_torch.data import decode_tokens, make_lm_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training.loop import Trainer, TrainerConfig

    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    loader, service, _ = make_lm_pipeline(
        n_samples=1024, seq_len=TRAIN_S, vocab=cfg.vocab, batch_size=TRAIN_B, cache_items=256,
        policy=PrefetchConfig.fifty_fifty(256),
    )
    t0 = time.monotonic()
    trainer = Trainer(cfg, loader, TrainerConfig(seq_len=TRAIN_S, batch_size=TRAIN_B, log_every=1000),
                      decode_fn=decode_tokens)  # the card, by default; no checkpoint dir
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    with service:
        metrics = trainer.train(TRAIN_STEPS)
    counts = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(metrics) == TRAIN_STEPS, f"trained {len(metrics)} steps, want {TRAIN_STEPS}")
    losses = [m.loss for m in metrics]
    check(all(np.isfinite(losses)), f"training losses not finite: {losses}")
    check(peak_gb < 80, f"peak memory {peak_gb:.2f} GB")
    check(not any(counts.values()), f"the training main path launched hand kernels: {counts}")
    step_s = float(np.median([m.compute_s for m in metrics]))
    tokens = TRAIN_B * TRAIN_S
    n_active = cfg.active_param_count()
    wait = sum(m.data_wait_s for m in metrics)
    comp = sum(m.compute_s for m in metrics)
    row = dict(
        arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, params=n_active,
        params_total=cfg.param_count(), init_s=init_s, batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
        moment_dtype=trainer.settings.moment_dtype, remat_policy="minimal",
        loss=losses, compute_s=[m.compute_s for m in metrics],
        data_wait_s=[m.data_wait_s for m in metrics], wait_fraction=wait / (wait + comp),
        hits=sum(m.hits for m in metrics), misses=sum(m.misses for m in metrics),
        median_step_s=step_s, tokens_per_s=tokens / step_s,
        # the reference's model_flops (6·N_active·tokens) against the bf16 peak
        mfu=6.0 * n_active * tokens / step_s / PEAK_FLOPS[torch.bfloat16],
        # the same without the embedding table, a gather that does no FLOPs
        mfu_without_embed=6.0 * (n_active - cfg.vocab * cfg.d_model) * tokens / step_s
        / PEAK_FLOPS[torch.bfloat16],
        card=card, peak_mem_gb=peak_gb, launches=counts,
    )
    print("train " + json.dumps(row), flush=True)
    step = make_train_step(cfg, trainer.settings)
    batch = train_batch(cfg.vocab, TRAIN_B, TRAIN_S, 6, "cuda")
    row["profile"] = profile_once(
        lambda: step(trainer.params, trainer.opt_state, batch)[0].item(), cfg.name, "train_step", 10
    )
    row["phases_s"] = train_phases(cfg, trainer, batch)
    del trainer, loader, service
    torch.cuda.empty_cache()
    return row


def train_phases(cfg, trainer, batch) -> dict:
    """One step split in its two halves on the host clock, each ending in a
    synchronise: forward + backward (``loss_and_grads``, the recompute
    included) and the optimizer (``adamw_update``)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.training.optimizer import adamw_update

    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, grads = loss_and_grads(trainer.params, cfg, batch)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    adamw_update(trainer.params, grads, trainer.opt_state, trainer.settings)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    for p in trainer.params.parameters():
        p.grad = None
    phases = dict(loss_and_grads_s=t1 - t0, adamw_update_s=t2 - t1)
    print("train_phases " + json.dumps(dict(arch=cfg.name, **phases)), flush=True)
    return phases


# ---------------------------------------------------------------------------
# The sharded MoE block: two gloo ranks on the one card
# ---------------------------------------------------------------------------
SHARDED_ARCH = "phi3.5-moe-42b-a6.6b"
SHARDED_B, SHARDED_S, SHARDED_RANKS = 4, 1024, 2


def sharded_inputs(cfg, dtype, experts: range) -> tuple:
    """The block's router, the given experts' leaves and x (B, S, d), drawn
    on the card in f32 from seeds (each expert from its own, so a rank draws
    only its experts) and cast to ``dtype``."""
    d, f = cfg.d_model, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(11)
    router = torch.randn(d, cfg.n_experts, generator=g, device="cuda") / d ** 0.5
    x = torch.randn(SHARDED_B, SHARDED_S, d, generator=g, device="cuda")
    leaves = {"w_gate": [], "w_up": [], "w_down": []}
    for e in experts:
        g = torch.Generator(device="cuda").manual_seed(1000 + e)
        for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))):
            leaves[name].append((torch.randn(*shape, generator=g, device="cuda") / shape[0] ** 0.5).to(dtype))
    params = {"router": router.to(dtype), **{k: torch.stack(v) for k, v in leaves.items()}}
    return params, x.to(dtype)


def wall_ms(fn) -> tuple:
    """(result, host ms) of one call after a warm-up call, synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


def moe_sharded_rank(rank: int, world: int) -> dict:
    """One rank of the sharded block: a (data 1, model ``world``) mesh on
    the card over a gloo group, this rank's experts, every rank the whole
    batch; y in f32 and bf16 and the wall ms of each."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.moe import moe_block
    from repro_torch.models.parallel import MeshContext

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(SHARDED_ARCH)
    ctx = MeshContext(make_smoke_mesh(1, world, device_type="cuda"), batch_axes=("data",))
    n_local = cfg.n_experts // world
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        params, x = sharded_inputs(cfg, dtype, range(rank * n_local, (rank + 1) * n_local))
        with torch.no_grad():
            y, ms = wall_ms(lambda: moe_block(params, x, cfg, ctx))
        out[f"{dtype}|y"] = y.float().cpu().numpy()
        out[f"{dtype}|ms"] = np.array(ms)
        del params, x, y
    return out


def moe_sharded_check(configs, kernels) -> dict:
    """phi3.5-moe's MoE block at full width (d 4096, d_ff 6400, 16 experts,
    top-2), x of 4 x 1024, through ``run_ranks``: two gloo ranks on the one
    card, 8 experts each, the combine an ``all_reduce`` of CUDA tensors.
    Held against the same block run here in one process: f32 exactly equal
    to the local path (a data axis of 1: every token's two expert terms sum
    the same way), bf16 exactly equal to bf16(bf16(p0) + bf16(p1)) of the
    two halves' partial sums, the reference's combine rule.  The wall ms
    are of two processes sharing one card, so not a speed."""
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.models.moe import _capacity, _moe_local, moe_block

    cfg = configs.get(SHARDED_ARCH)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = run_ranks(moe_sharded_rank, SHARDED_RANKS, device="cuda", timeout_s=600)
    ranks_s = time.monotonic() - t0
    n_local = cfg.n_experts // SHARDED_RANKS
    row = dict(arch=SHARDED_ARCH, ranks=SHARDED_RANKS, mesh="data 1 x model 2", backend="gloo",
               combine="all_reduce of CUDA tensors", batch=SHARDED_B, seq=SHARDED_S,
               experts_per_rank=n_local, run_ranks_s=ranks_s)
    zero_counts(kernels)
    for dtype in (torch.float32, torch.bfloat16):
        params, x = sharded_inputs(cfg, dtype, range(cfg.n_experts))
        with torch.no_grad():
            if dtype == torch.float32:
                want, local_ms = wall_ms(lambda: moe_block(params, x, cfg))
            else:
                flat = x.reshape(-1, cfg.d_model)
                cap = _capacity(flat.shape[0], cfg, None)

                def halves():
                    parts = [_moe_local({k: v if k == "router" else v[e0:e0 + n_local] for k, v in params.items()},
                                        flat, cfg, cap, n_local, e0).to(dtype)
                             for e0 in range(0, cfg.n_experts, n_local)]
                    return (parts[0] + parts[1]).reshape(x.shape)

                want, local_ms = wall_ms(halves)
        want = want.float().cpu().numpy()
        name = str(dtype).replace("torch.", "")
        errs = []
        for r, res in enumerate(ranks):
            got = res[f"{dtype}|y"]
            check(np.isfinite(got).all() and got.shape == want.shape, f"moe_sharded {name}: rank {r} {got.shape}")
            errs.append(float(np.abs(got - want).max()))
            check(np.array_equal(got, want), f"moe_sharded {name}: rank {r} differs from the local block "
                                             f"by {errs[-1]} (max abs)")
        row[name] = dict(equal=True, max_abs_err=max(errs), local_ms=local_ms,
                         rank_ms=[float(res[f"{dtype}|ms"]) for res in ranks],
                         rank_ms_note="two processes sharing one card: not a speed")
        del params, x
    counts = read_counts(kernels)
    check(not any(counts.values()), f"the sharded MoE block check launched hand kernels: {counts}")
    row["launches"] = counts
    print("moe_sharded " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Sharded training: two gloo ranks on the one card
# ---------------------------------------------------------------------------
# (arch, layers, (data, model), global batch, seq), all on one group of two
# gloo ranks: danube cut to 2 layers with the batch split over data (one row
# a rank) and with its heads and d_ff split over model (tensor-parallel
# attention and MLP, forward and backward), phi3.5-moe cut to 1 layer
# (train_check's size, about 25 GB of f32 state in one process) with its 16
# experts split over model (8 a rank) and its attention heads too
SHARDED_TRAIN_CASES = (("h2o-danube-3-4b", 2, (2, 1), 2, 512),
                       ("phi3.5-moe-42b-a6.6b", 1, (1, 2), 1, 256),
                       ("h2o-danube-3-4b", 2, (1, 2), 2, 512))


def sharded_case_key(arch: str, mesh) -> str:
    return f"{arch}|{mesh[0]}x{mesh[1]}"


def sharded_train_cfg(configs, arch: str, layers: int):
    return dataclasses.replace(configs.get(arch), n_layers=layers, dtype="float32")


class StepSpy:
    """Wraps ``launch.steps.adamw_update`` while in use: the gradients the
    train step hands the optimizer (on the host, f32) and their global norm,
    so one ``make_train_step`` call gives both."""

    def __init__(self, norm):
        self.norm, self.grads, self.grad_norm = norm, None, None

    def __enter__(self):
        from repro_torch.launch import steps

        self.steps, self.orig = steps, steps.adamw_update

        def spied(params, grads, opt_state, settings):
            self.grad_norm = float(self.norm(params, grads))
            self.grads = {n: g.float().cpu() for n, g in grads.items()}
            return self.orig(params, grads, opt_state, settings)

        steps.adamw_update = spied
        return self

    def __exit__(self, *exc):
        self.steps.adamw_update = self.orig


class VocabWidths:
    """While in use, records the columns of each head product and the rows
    of each embedding table looked up (``models.model.head_logits``,
    ``embed_tokens``): V/m a rank where the vocabulary splits over model."""

    def __enter__(self):
        from repro_torch.models import model

        self.model, self.orig = model, (model.head_logits, model.embed_tokens)
        self.head_cols, self.embed_rows = set(), set()

        def head(hidden, w, *a, **k):
            self.head_cols.add(int(w.shape[1]))
            return self.orig[0](hidden, w, *a, **k)

        def embed(table, *a, **k):
            self.embed_rows.add(int(table.shape[0]))
            return self.orig[1](table, *a, **k)

        model.head_logits, model.embed_tokens = head, embed
        return self

    def __exit__(self, *exc):
        self.model.head_logits, self.model.embed_tokens = self.orig

    def put(self, out: dict, key: str) -> None:
        out[f"{key}|head_cols"] = np.array(sorted(self.head_cols))
        out[f"{key}|embed_rows"] = np.array(sorted(self.embed_rows))


def check_vocab_widths(res: dict, key: str, vocab: int, m: int, what: str) -> list:
    """The head columns and embedding rows a rank saw: V/m each where m
    divides the vocabulary, else V.  Returns the head columns."""
    want = [vocab // m if vocab % m == 0 else vocab]
    cols, rows = res[f"{key}|head_cols"].tolist(), res[f"{key}|embed_rows"].tolist()
    check(cols == want and rows == want, f"{what}: head columns {cols}, embedding rows {rows}, want {want}")
    return cols


def train_sharded_rank(rank: int, world: int) -> dict:
    """One rank of the sharded f32 train step on the card, every case of
    ``SHARDED_TRAIN_CASES`` in turn (each on its own mesh over the one
    group): one ``make_train_step`` from fresh moments, its loss, the
    gradient shards and global norm it handed the optimizer, every updated
    shard and its slices, the step's wall ms (with the
    gradients' copy to the host) and the rank's peak memory."""
    from repro_torch import configs
    from repro_torch.distributed.sharding import ShardedLM, ShardingRules
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import DecoderLM
    from repro_torch.training.optimizer import OptSettings, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, layers, (n_data, n_model), B, S in SHARDED_TRAIN_CASES:
        cfg = sharded_train_cfg(configs, arch, layers)
        rules = ShardingRules(make_smoke_mesh(n_data, n_model, device_type="cuda"), fsdp_axes=("data",))
        key = sharded_case_key(arch, (n_data, n_model))
        model = ShardedLM(DecoderLM.from_config(cfg, seed=0, device="cuda"), rules, trainable=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        settings = OptSettings.auto(cfg.param_count())
        opt = adamw_init(model, settings)
        step = make_train_step(cfg, settings, rules, B)
        batch = train_batch(cfg.vocab, B, S, 7, "cuda")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with StepSpy(lambda m, g: m.grad_norm(g)) as spy, VocabWidths() as widths:
            loss, model, opt = step(model, opt, batch)
        widths.put(out, key)
        out[f"{key}|loss"] = loss.cpu().numpy()
        out[f"{key}|step_ms"] = np.array((time.monotonic() - t0) * 1e3)
        out[f"{key}|peak_gb"] = np.array(torch.cuda.max_memory_allocated() / 1e9)
        out[f"{key}|grad_norm"] = np.array(spy.grad_norm)
        for n, p in model.named_parameters():
            out[f"{key}|param|{n}"] = p.detach().float().cpu().numpy()
            out[f"{key}|grad|{n}"] = spy.grads[n].numpy()
            out[f"{key}|slice|{n}"] = np.array([(s.start, s.stop) for s in model.slices(n)])
        del model, opt, spy, batch, loss
        torch.cuda.empty_cache()
    return out


def train_sharded_check(configs, kernels) -> list:
    """Each case of ``SHARDED_TRAIN_CASES`` in f32: first one process on the
    card (the gradients and norm its step hands AdamW, its loss and updated
    parameters, kept on the host, the card freed), then the sharded step on
    two gloo ranks of the card through ``run_ranks``, one group for every
    case.  Each rank returns its shards, held against its slices of the
    one-process results at 2e-3: the loss, the global grad norm, every
    gradient (2e-3 of the leaf's largest magnitude, plus 2e-3 relative) and
    every updated parameter.  The wall ms are of two processes sharing one
    card, so not a speed."""
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import DecoderLM
    from repro_torch.training.optimizer import OptSettings, _global_norm, adamw_init

    t_phase = time.monotonic()
    zero_counts(kernels)
    one = {}
    for arch, layers, mesh, B, S in SHARDED_TRAIN_CASES:
        if (arch, layers, B, S) in one:  # one process runs a step once for every mesh
            continue
        cfg = sharded_train_cfg(configs, arch, layers)
        settings = OptSettings.auto(cfg.param_count())
        model = DecoderLM.from_config(cfg, seed=0, device="cuda", trainable=True)
        opt = adamw_init(model, settings)
        step = make_train_step(cfg, settings)
        batch = train_batch(cfg.vocab, B, S, 7, "cuda")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with StepSpy(lambda m, g: _global_norm(g.values())) as spy:
            loss, model, opt = step(model, opt, batch)
        one[arch, layers, B, S] = dict(loss=loss.item(), ms=(time.monotonic() - t0) * 1e3, grad_norm=spy.grad_norm,
                                       grads=spy.grads,
                                       params={n: p.detach().cpu() for n, p in model.named_parameters()})
        del model, opt, batch, loss, spy
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = run_ranks(train_sharded_rank, 2, backend="gloo", device="cuda", timeout_s=600)
    ranks_s = time.monotonic() - t0
    rows = []
    for arch, layers, mesh, B, S in SHARDED_TRAIN_CASES:
        want = one[arch, layers, B, S]
        case = sharded_case_key(arch, mesh)
        worst = dict(params=0.0, grads=0.0)
        vocab = sharded_train_cfg(configs, arch, layers).vocab
        head_cols = [check_vocab_widths(res, case, vocab, mesh[1], f"train_sharded {arch} {mesh} rank {r}")
                     for r, res in enumerate(ranks)]
        for r, res in enumerate(ranks):
            for what, key in (("loss", "loss"), ("global grad norm", "grad_norm")):
                a, b = float(res[f"{case}|{key}"]), want[key]
                check(np.isfinite(a) and abs(a - b) <= MODEL_TOL * (1 + abs(b)),
                      f"train_sharded {arch}: rank {r} {what} {a}, one process {b}")
            for n, p in want["params"].items():
                sl = tuple(slice(int(a), int(b)) for a, b in res[f"{case}|slice|{n}"])
                ok, err, share = close(torch.from_numpy(res[f"{case}|param|{n}"]), p[sl], MODEL_TOL)
                check(ok, f"train_sharded {arch}: rank {r} parameter {n} differs by {err}")
                worst["params"] = max(worst["params"], share)
                g = want["grads"][n][sl]
                scale = max(g.abs().max().item(), torch.finfo(torch.float32).tiny)
                ok, err, share = close(torch.from_numpy(res[f"{case}|grad|{n}"]), g, MODEL_TOL, MODEL_TOL * scale)
                check(ok, f"train_sharded {arch}: rank {r} gradient of {n} differs by {err} "
                          f"(largest magnitude {scale})")
                worst["grads"] = max(worst["grads"], share)
        row = dict(arch=arch, layers=layers, dtype="float32", mesh=f"data {mesh[0]} x model {mesh[1]}",
                   backend="gloo", gather="all_gather_into_tensor",
                   reduce="reduce_scatter_tensor (all_reduce where the leaf is replicated)", batch=B, seq=S,
                   params=sharded_train_cfg(configs, arch, layers).param_count(),
                   loss=want["loss"], grad_norm=want["grad_norm"],
                   rank_loss=[float(res[f"{case}|loss"]) for res in ranks],
                   rank_grad_norm=[float(res[f"{case}|grad_norm"]) for res in ranks],
                   params_worst_tol_share=worst["params"], grads_worst_tol_share=worst["grads"],
                   vocab=vocab, rank_head_cols=head_cols,
                   one_process_step_ms=want["ms"], rank_step_ms=[float(res[f"{case}|step_ms"]) for res in ranks],
                   rank_peak_gb=[float(res[f"{case}|peak_gb"]) for res in ranks], run_ranks_s=ranks_s,
                   phase_s_so_far=time.monotonic() - t_phase,
                   rank_ms_note="two processes sharing one card, the gradients copied to the host "
                                "inside the step: not a speed")
        print("train_sharded " + json.dumps(row), flush=True)
        rows.append(row)
    del one
    counts = read_counts(kernels)
    check(not any(counts.values()), f"the sharded training check launched hand kernels: {counts}")
    return rows


# ---------------------------------------------------------------------------
# Tensor-parallel serving: two gloo ranks on the one card
# ---------------------------------------------------------------------------


def kernel_fns() -> dict:
    """Every kernel wrapper with a launch count, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd

    return {fn.__name__: fn for fn in (fa.flash_attention, fa.flash_attention_tc, fa.flash_attention_cuda_core,
                                       ssd.ssd_scan, ssd.ssd_scan_tc, ssd.ssd_scan_cuda_core)}


class EntryInputs:
    """While in use, keeps the inputs of every call of a ``kernels.ops``
    entry point (``flash_attention`` or ``ssd_scan``), passing each on."""

    def __init__(self, name: str):
        self.name, self.calls = name, []

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig = ops, getattr(ops, self.name)

        def kept(*a, **k):
            self.calls.append((a, k))
            return self.orig(*a, **k)

        setattr(ops, self.name, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)


def tp_greedy(prefill, decode, model, prompt, n_new: int, grow) -> tuple:
    """Prefill, ``grow`` the caches by ``n_new`` slots, ``n_new`` greedy
    steps: (tokens (B, n_new), the logits of every step (n_new, B, V) f32,
    prefill ms, decode ms a step), on the host."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, state = prefill(model, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    state = grow(state, n_new)
    toks, seen = [], []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for step in range(n_new):
        seen.append(logits.float().cpu())
        tok = torch.argmax(logits, -1)[:, None]
        toks.append(tok.cpu())
        if step + 1 < n_new:
            logits, state = decode(model, state, tok, prompt.shape[1] + step)
    torch.cuda.synchronize()
    return torch.cat(toks, 1), torch.stack(seen), prefill_ms, (time.monotonic() - t0) * 1e3 / (n_new - 1)


def tp_kernel_vs_plain(entry: str, call, dtype) -> dict:
    """The kernel the dtype picks against its plain version on the inputs
    of one call of the ``kernels.ops`` entry point ``entry`` (launches made
    here are not the main path's)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd

    (a, k) = call
    tc = dtype == torch.bfloat16
    if entry == "flash_attention":
        kern = fa.flash_attention_tc if tc else fa.flash_attention_cuda_core
        got, want, tol = kern(*a, **k), fa.flash_attention_plain(*a, **k), KERNEL_TOL[dtype]
        ok, err, share = close(got, want, tol)
        return dict(q=list(a[0].shape), kv=list(a[1].shape), ok=ok, max_abs_err=err, tol=tol, tol_share=share)
    kern = ssd.ssd_scan_tc if tc else ssd.ssd_scan_cuda_core
    (y, st), (wy, wst), tol = kern(*a, **k), ssd.ssd_scan_plain(*a, **k), SSD_TOL[dtype]
    ok_y, err_y, share_y = close(y, wy, tol)
    ok_s, err_s, share_s = close(st, wst, tol)
    return dict(x=list(a[0].shape), ok=ok_y and ok_s, max_abs_err=max(err_y, err_s), tol=tol,
                tol_share=max(share_y, share_s))


def tp_serve_rank(rank: int, world: int, parts: str) -> dict:
    """One rank of ``tp_serve`` on a (data 1, model ``world``) mesh of the
    card: the ``parts`` of (a) to (e) in turn, each with the launch counts of
    its counted call, the inputs of that call's kernels held against their
    plain versions (every run of the first layer's heads), and its outputs
    or their errors against one process."""
    from repro_torch import configs
    from repro_torch.distributed.sharding import ShardedLM, ShardingRules, gather, shard_state
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.models.parallel import MeshContext, head_runs
    from repro_torch.models.ssm import ssm_block, ssm_param_shapes
    from repro_torch.serving.engine import grow_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = kernel_fns()
    mesh = make_smoke_mesh(1, world, device_type="cuda")
    rules = ShardingRules(mesh, fsdp_axes=("data",))
    ctx = MeshContext(mesh, batch_axes=("data",))
    out = {}

    def counted(fn, key):
        def call(*a):
            zero_counts(kernels)
            res = fn(*a)
            torch.cuda.synchronize()
            for name, n in read_counts(kernels).items():
                out[f"{key}|launches|{name}"] = np.array(n)
            return res
        return call

    def grow_one(state, n):
        return grow_kv(state[0], n), state[1]

    def grow_ranks(cfg, B):
        def grow(state, n):
            caches, kv_len = state
            held = {pos: {name: gather(t, keep_dims=(1,)) for name, t in sub.items()}
                    for pos, sub in caches.items()}
            return shard_state(rules, cfg, (grow_kv(held, n), kv_len.to_local()), B)
        return grow

    def serve(key, cfg, B, S, single: bool):
        model = M.DecoderLM.from_config(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(21)
        prompt = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
        with torch.no_grad():
            one = tp_greedy(make_prefill_step(cfg), make_decode_step(cfg), model, prompt, TP_NEW,
                            grow_one) if single else None
        sharded = ShardedLM(model, rules)
        del model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with EntryInputs("flash_attention") as flash, VocabWidths() as widths:
            toks, logits, prefill_ms, decode_ms = tp_greedy(
                counted(make_prefill_step(cfg, rules, B), key), make_decode_step(cfg, rules, B), sharded,
                prompt, TP_NEW, grow_ranks(cfg, B))
        widths.put(out, key)
        out[f"{key}|peak_gb"] = np.array(torch.cuda.max_memory_allocated() / 1e9)
        out[f"{key}|prefill_ms"], out[f"{key}|decode_ms"] = np.array(prefill_ms), np.array(decode_ms)
        out[f"{key}|tokens"] = toks.numpy()
        out[f"{key}|finite"] = np.array(bool(torch.isfinite(logits).all()))
        runs = len(head_runs(cfg, *ctx.heads(cfg.n_heads)))
        out[f"{key}|flash_shapes"] = np.array([list(a[0].shape) + list(a[1].shape) for a, _ in flash.calls])
        out[f"{key}|kernel"] = np.array(json.dumps([tp_kernel_vs_plain("flash_attention", call, cfg.torch_dtype)
                                                    for call in flash.calls[:runs]]))
        if single:
            out[f"{key}|one_tokens"] = one[0].numpy()
            out[f"{key}|logits_err"] = np.array((logits - one[1]).abs().max().item())
            out[f"{key}|logits_share"] = np.array(close(logits, one[1], MODEL_TOL)[2])
        del sharded, flash
        torch.cuda.empty_cache()

    full = configs.get(TP_ARCH)
    if "a" in parts:
        serve("a", dataclasses.replace(full, n_layers=TP_F32_LAYERS, dtype="float32"), TP_F32_B, TP_F32_S, True)
    if "b" in parts:
        serve("b", full, TP_BF16_B, TP_BF16_S, False)
    uneven = configs.get(TP_UNEVEN_ARCH)
    if "d" in parts:
        serve("d", dataclasses.replace(uneven, n_layers=TP_F32_LAYERS, dtype="float32"), TP_F32_B, TP_F32_S, True)
    if "e" in parts:
        serve("e", dataclasses.replace(uneven, n_layers=TP_UNEVEN_BF16_LAYERS), TP_BF16_B, TP_BF16_S, False)

    for dtype in ("float32", "bfloat16") if "c" in parts else ():
        key = f"c|{dtype}"
        cfg = dataclasses.replace(configs.get(HYBRID), dtype=dtype)
        g = torch.Generator(device="cuda").manual_seed(9)
        params = M._init_tree(g, torch.device("cuda"), ssm_param_shapes(cfg), cfg)
        x = torch.randn(JAMBA_SSM_B, JAMBA_SSM_S, cfg.d_model, generator=g, device="cuda").to(cfg.torch_dtype)
        h0, h1 = ctx.part(cfg.ssm_heads)
        local = dict(params, out_proj=params["out_proj"][h0 * cfg.ssm_head_dim:h1 * cfg.ssm_head_dim])
        with torch.inference_mode(), EntryInputs("ssd_scan") as scans:
            y, (st, _) = counted(lambda: ssm_block(local, x, cfg, ctx), key)()
            out[f"{key}|ssd_heads"] = np.array([a[0].shape[2] for a, _ in scans.calls])
            out[f"{key}|kernel"] = np.array(json.dumps(tp_kernel_vs_plain("ssd_scan", scans.calls[0], cfg.torch_dtype)))
            out[f"{key}|finite"] = np.array(bool(torch.isfinite(y).all()))
            if dtype == "float32":
                want, (want_st, _) = ssm_block(params, x, cfg)
                ok, err, share = close(y, want, MODEL_TOL)
                out[f"{key}|y_err"], out[f"{key}|y_share"] = np.array(err), np.array(share)
                out[f"{key}|state_share"] = np.array(close(st, want_st[:, h0:h1], MODEL_TOL)[2])
        del params, x, local, y, st, scans
        torch.cuda.empty_cache()
    return out


def tp_serve_rows(configs, kernels, ranks: list, ranks_s: float, arch: str, parts: tuple,
                  want_runs: list) -> dict:
    """Checks each serving part's ranks and prints its ``tp_serve`` line:
    each rank's flash launches exactly its layers x its runs of heads
    (``want_runs`` a rank), the q / k shapes of every launch, each run of the
    first layer against the plain version, tokens equal across the ranks
    and, where one process ran too, equal to its tokens with the logits
    within 2e-3.  Returns the launch counts by run."""
    from repro_torch.models.parallel import head_range, head_runs, kv_heads_read

    cfg, world = configs.get(arch), len(ranks)
    hd, runs = cfg.head_dim, {}
    for key, B, S, layers, dtype in parts:
        variant = "tc" if dtype == "bfloat16" else "cuda_core"
        row = dict(part=key, arch=arch, dtype=dtype, layers=layers, batch=B, prompt_len=S, new_tokens=TP_NEW,
                   mesh=f"data 1 x model {world}", backend="gloo", ranks=[])
        for r, res in enumerate(ranks):
            h0, h1 = head_range(cfg.n_heads, world, r)
            heads = head_runs(cfg, h0, h1)
            check(len(heads) == want_runs[r], f"tp_serve ({key}) rank {r}: heads {h0}-{h1} in runs {heads}, "
                                              f"want {want_runs[r]}")
            n = layers * len(heads)
            counts = {name: int(res[f"{key}|launches|{name}"]) for name in kernels}
            check_counts(f"{arch} tp_serve ({key}) rank {r}", counts,
                         {"flash_attention": n, f"flash_attention_{variant}": n}, "prefill")
            runs[f"{arch} {dtype} tp_serve ({key}) rank {r}"] = counts
            want = [[B, S, hi - lo, hd, B, S, c1 - c0, hd]
                    for lo, hi in heads for c0, c1 in [kv_heads_read(cfg, lo, hi)]]
            shapes = res[f"{key}|flash_shapes"].tolist()
            check(shapes == want * layers, f"tp_serve ({key}) rank {r}: flash saw q/k shapes {shapes[:len(want)]} "
                                           f"... ({len(shapes)} calls), want {want} a layer")
            kern = json.loads(str(res[f"{key}|kernel"]))
            check(len(kern) == len(heads) and all(k["ok"] for k in kern),
                  f"tp_serve ({key}) rank {r}: flash kernel vs plain {kern}")
            toks = res[f"{key}|tokens"]
            check(bool(res[f"{key}|finite"]) and toks.shape == (B, TP_NEW) and ((0 <= toks) & (toks < cfg.vocab)).all(),
                  f"tp_serve ({key}) rank {r}: logits not finite or tokens {toks.shape}")
            check(np.array_equal(toks, ranks[0][f"{key}|tokens"]), f"tp_serve ({key}): ranks' tokens differ")
            head_cols = check_vocab_widths(res, key, cfg.vocab, world, f"tp_serve ({key}) rank {r}")
            rank = dict(heads=[h0, h1], runs=[hi - lo for lo, hi in heads], launches=counts, kernel=kern,
                        head_cols=head_cols[0], peak_gb=float(res[f"{key}|peak_gb"]),
                        prefill_ms=float(res[f"{key}|prefill_ms"]), decode_ms_per_step=float(res[f"{key}|decode_ms"]))
            if f"{key}|one_tokens" in res:
                check(np.array_equal(toks, res[f"{key}|one_tokens"]),
                      f"tp_serve ({key}) rank {r}: tokens {toks.tolist()}, one process {res[f'{key}|one_tokens'].tolist()}")
                check(float(res[f"{key}|logits_share"]) <= 1.0,
                      f"tp_serve ({key}) rank {r}: logits differ from one process by {float(res[f'{key}|logits_err'])}")
                rank.update(logits_max_abs_err=float(res[f"{key}|logits_err"]),
                            logits_tol_share=float(res[f"{key}|logits_share"]), tokens_equal_one_process=True)
            row["ranks"].append(rank)
        row.update(ms_note="gloo through the host on one card: not a speed", run_ranks_s=ranks_s)
        print("tp_serve " + json.dumps(row), flush=True)
    return runs


def tp_serve_check(configs, kernels) -> dict:
    """Tensor-parallel serving on gloo ranks of the card (``run_ranks``).
    On two ranks, mesh data 1 x model 2, each rank on its half of the heads
    and d_ff: (a) danube f32 at full width cut to 2 layers,
    ``make_prefill_step`` on 2 x 512 then 8 greedy ``make_decode_step``
    steps, each rank's logits within 2e-3 of one process and its tokens
    equal, exactly 2 CUDA-core flash launches a prefill at q (2, 512, 16,
    120), k/v (2, 512, 4, 120); (b) danube bf16 at full width and depth, 4 x
    1024 then 8 steps, exactly 24 tensor-core flash launches a prefill at 16
    / 4 heads, the kernel against its plain version on the first layer's
    inputs at 2e-2, each rank's peak memory and wall ms (gloo through the
    host on one card: not a speed); (c) one jamba SSM layer at full width, B
    1 x S 8192: one SSD launch a call on 128 heads, the kernel against its
    plain version on those inputs (2e-2 bf16, 2e-4 f32), the f32 layer
    within 2e-3 of one process.  Then on three ranks, mesh data 1 x model
    3, deepseek-coder-33b at full width, whose 56 heads split 19 / 19 / 18
    in 2 / 3 / 2 runs: (d) as (a) at 2 layers and (e) as (b) at 8 layers,
    each rank's flash launches its layers x its runs, each run of the first
    layer against the plain version.  Returns the launch counts by run."""
    from repro_torch.distributed.ranks import run_ranks

    t0 = time.monotonic()
    zero_counts(kernels)
    ranks = run_ranks(tp_serve_rank, TP_RANKS, args=("abc",), device="cuda", timeout_s=900)
    ranks_s = time.monotonic() - t0
    full = configs.get(TP_ARCH)
    runs = tp_serve_rows(configs, kernels, ranks, ranks_s, TP_ARCH,
                         (("a", TP_F32_B, TP_F32_S, TP_F32_LAYERS, "float32"),
                          ("b", TP_BF16_B, TP_BF16_S, full.n_layers, "bfloat16")), [1] * TP_RANKS)
    ssm_heads = configs.get(HYBRID).ssm_heads // TP_RANKS
    for dtype in ("float32", "bfloat16"):
        key = f"c|{dtype}"
        variant = "tc" if dtype == "bfloat16" else "cuda_core"
        want = {"ssd_scan": 1, f"ssd_scan_{variant}": 1}
        row = dict(part="c", arch=HYBRID, layer="ssm_block", dtype=dtype, batch=JAMBA_SSM_B, seq=JAMBA_SSM_S,
                   mesh="data 1 x model 2", ranks=[])
        for r, res in enumerate(ranks):
            counts = {name: int(res[f"{key}|launches|{name}"]) for name in kernels}
            check_counts(f"{HYBRID} tp_serve (c) {dtype} rank {r}", counts, want, "ssm_block")
            runs[f"{HYBRID} ssm_block {dtype} tp_serve (c) rank {r}"] = counts
            heads = res[f"{key}|ssd_heads"].tolist()
            check(heads == [ssm_heads], f"tp_serve (c) {dtype} rank {r}: SSD ran on {heads} heads")
            kern = json.loads(str(res[f"{key}|kernel"]))
            check(kern["ok"] and bool(res[f"{key}|finite"]), f"tp_serve (c) {dtype} rank {r}: SSD kernel vs plain {kern}")
            rank = dict(launches=counts, ssd_heads=heads[0], kernel=kern)
            if dtype == "float32":
                check(float(res[f"{key}|y_share"]) <= 1.0 and float(res[f"{key}|state_share"]) <= 1.0,
                      f"tp_serve (c) rank {r}: the f32 layer differs from one process by {float(res[f'{key}|y_err'])}")
                rank.update(y_max_abs_err=float(res[f"{key}|y_err"]), y_tol_share=float(res[f"{key}|y_share"]),
                            state_tol_share=float(res[f"{key}|state_share"]))
            row["ranks"].append(rank)
        print("tp_serve " + json.dumps(row), flush=True)
    t1 = time.monotonic()
    ranks = run_ranks(tp_serve_rank, TP_UNEVEN_RANKS, args=("de",), device="cuda", timeout_s=900)
    runs.update(tp_serve_rows(configs, kernels, ranks, time.monotonic() - t1, TP_UNEVEN_ARCH,
                              (("d", TP_F32_B, TP_F32_S, TP_F32_LAYERS, "float32"),
                               ("e", TP_BF16_B, TP_BF16_S, TP_UNEVEN_BF16_LAYERS, "bfloat16")), [2, 3, 2]))
    print(f"tp_serve: phase {time.monotonic() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return runs


def roofline_check(configs, train_row: dict) -> dict:
    """``launch/counting.py`` and ``launch/roofline.py::analyze`` over one
    step of danube's training cell (the full model, bf16, 2 x 2048, one
    process, real tensors on the card), beside the median ``compute_s`` the
    ``train`` phase measured: the counted FLOPs and eager bytes, the
    roofline terms and ``bound_s``."""
    from repro_torch.launch.counting import count_step
    from repro_torch.launch.roofline import analyze
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import DecoderLM
    from repro_torch.training.optimizer import OptSettings, adamw_init

    cfg = configs.get(TRAIN_ARCH)
    shape = ShapeConfig(f"train_{TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B, "train")
    settings = OptSettings.auto(cfg.param_count())
    model = DecoderLM.from_config(cfg, seed=0, device="cuda", trainable=True)
    opt = adamw_init(model, settings)
    step = make_train_step(cfg, settings)
    batch = train_batch(cfg.vocab, TRAIN_B, TRAIN_S, 6, "cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    (loss, _, _), counts = count_step(step, model, opt, batch)
    loss = loss.item()
    counted_s = time.monotonic() - t0
    r = analyze(cfg.name, shape.name, "1x1", 1, counts, cfg, shape)
    measured = train_row["median_step_s"]
    row = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, batch=TRAIN_B, seq=TRAIN_S, mesh="1x1",
               flops=counts.flops, hbm_bytes=counts.hbm_bytes, collective_bytes=counts.collective_bytes,
               model_flops=r.model_flops, useful_ratio=r.useful_ratio, compute_s=r.compute_s,
               memory_s=r.memory_s, collective_s=r.collective_s, bound_s=r.bound_s, dominant=r.dominant,
               measured_median_compute_s=measured, measured_over_bound=measured / r.bound_s,
               counted_step_s=counted_s, loss=loss,
               note="memory_s is eager bytes (every op's inputs and outputs) at 3.35 TB/s: "
                    "an unfused upper bound")
    print("roofline " + json.dumps(row), flush=True)
    check(np.isfinite(loss) and counts.flops > 0 and counts.hbm_bytes > 0 and counts.collective_bytes == 0,
          f"roofline: counts {counts}")
    check(r.compute_s < measured, f"roofline: the compute term {r.compute_s} s is over the measured "
                                  f"step {measured} s, so the FLOP count is wrong")
    check(0.3 < r.useful_ratio < 1.0, f"roofline: useful ratio {r.useful_ratio} (forward, recompute and "
                                      "backward of a dense model: about 0.7)")
    del model, opt, batch
    torch.cuda.empty_cache()
    return row


def train_e2e_example(tmp: str) -> dict:
    """The port's twin of examples/train_lm_e2e.py at its defaults (lm-100m,
    f32, 300 steps) on the card; its loss must fall."""
    from repro_torch.examples import train_lm_e2e

    res = train_lm_e2e.main(["--ckpt-dir", os.path.join(tmp, "e2e")])
    check(res["last_loss"] < res["first_loss"], f"lm-100m loss did not fall: {res}")
    print("train_e2e " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def checkpoint_round_trip(tmp: str) -> None:
    """lm-test after one step on the card, saved and restored into a model
    drawn from another seed: every parameter, moment and the step, bit for
    bit, in f32 and bf16."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model import DecoderLM
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import OptSettings, adamw_init

    for dtype in ("float32", "bfloat16"):
        cfg = ArchConfig(name="lm-test", family="dense", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=128, vocab=512, dtype=dtype, attn_chunk=64)
        settings = OptSettings(moment_dtype=dtype)
        model = DecoderLM.from_config(cfg, seed=0, trainable=True)
        opt = adamw_init(model, settings)
        _, model, opt = make_train_step(cfg, settings)(model, opt, train_batch(cfg.vocab, 2, 64, 7, "cuda"))
        d = os.path.join(tmp, f"ckpt_{dtype}")
        ckpt.save_checkpoint(d, 1, model, opt, extra={"step": 1})
        back = DecoderLM.from_config(cfg, seed=1, trainable=True)
        back_opt = adamw_init(back, settings)
        ckpt.restore_checkpoint(d, like=(back, back_opt))
        for (name, a), b in zip(model.named_parameters(), back.parameters()):
            check(torch.equal(a, b), f"checkpoint round trip ({dtype}): {name} differs")
        for kind in ("m", "v"):
            for name, t in opt[kind].items():
                check(torch.equal(t, back_opt[kind][name]), f"checkpoint round trip ({dtype}): {kind}/{name}")
        check(int(back_opt["step"]) == 1, "checkpoint round trip: step")
    print("checkpoint: lm-test f32 and bf16 restored bit for bit on the card", flush=True)


def kernel_line(name, variant, source, replaces, launches: dict, row) -> dict:
    """One kernel variant: ``launches`` by the run that counted them."""
    return dict(
        name=name, variant=variant, dtype=row["dtype"], route="cuda", source=source,
        replaces=replaces, launches=sum(launches.values()), launches_on=launches, shape=row["shape"],
        max_abs_err=row["max_abs_err"], ms=row["ms"], previous_ms=row["previous_ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=row["library_ms"], library_path=row.get("library_path"),
    )


TC_SOURCES = ("flash_attention_tc", "ssd_scan_tc")  # the tensor-core kernels' sources


def cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, or the copy Triton carries."""
    import importlib.util
    import shutil

    found = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        found.append(os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    for path in found:
        if path and os.path.exists(path):
            return path
    fail("no cuobjdump in the CUDA toolkit or under triton/backends/nvidia/bin")


def build_phase(_build) -> None:
    """Build every source; print ptxas's report of each kernel; fail on a
    spill in a tensor-core kernel or on a tensor-core library whose SASS has
    no tensor-core instruction."""
    t0 = time.monotonic()
    logs = _build.build()
    print(f"build: {_build.sources()} in {time.monotonic() - t0:.2f} s "
          f"({len(logs)} compiled now)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
                if name in TC_SOURCES and "spill" in line:
                    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
                    check(not any(spills), f"ptxas reports spills in {name}: {line.strip()}")
    tool = cuobjdump()
    for name in TC_SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "HGMMA")}
        print(f"sass {name}: " + json.dumps(counts), flush=True)
        check(sum(counts.values()) > 0, f"no tensor-core instruction in the SASS of {name}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch import ServeEngine, configs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
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
    build_phase(_build)

    kernels = kernel_fns()
    flash_rows = kernel_checks(fa)
    ssd_rows = ssd_checks(ssd)
    danube_f32 = serve_f32_checks(configs, M, DANUBE, kernels)
    danube = serve_main_path(configs, M, ServeEngine, DANUBE, kernels)
    mamba_f32 = serve_f32_checks(configs, M, MAMBA, kernels)
    mamba = serve_main_path(configs, M, ServeEngine, MAMBA, kernels)
    phi_f32 = serve_f32_checks(configs, M, PHI, kernels)
    phi = serve_main_path(configs, M, ServeEngine, PHI, kernels)  # frees the model
    hybrid = serve_hybrid_smoke(configs, M, ServeEngine, kernels)
    jamba_block = jamba_ssm_block_check(configs, M, kernels)
    vlm_f32 = vlm_f32_checks(configs, M, kernels)
    vlm = vlm_main_path(configs, M, kernels)
    encoder_f32 = encoder_f32_checks(configs, M, kernels)
    encoder = encoder_main_path(configs, M, kernels)

    train_f32_check(configs, kernels)
    danube_train = train_main_path(configs, kernels, card)
    roofline_check(configs, danube_train)
    train_f32_check(configs, kernels, MOE_TRAIN_ARCH, MOE_CHECK_LAYERS, MOE_CHECK_S)
    train_main_path(configs, kernels, card, MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS)
    moe_sharded_check(configs, kernels)
    train_sharded_check(configs, kernels)
    tp_runs = tp_serve_check(configs, kernels)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train_e2e_example(tmp)
        checkpoint_round_trip(tmp)

    flash_src, ssd_src = "src/repro/kernels/flash_attention.py:34", "src/repro/kernels/ssd.py:33"
    f32_row = lambda rows: next(r for r in rows if r["dtype"] == "float32")  # noqa: E731
    # launches by run: each main path's one prefill (bf16), each f32
    # full-width check's kernel-path prefill, the hybrid's ServeEngine
    runs = {f"{DANUBE.arch} bf16 main path": danube["launches"], f"{PHI.arch} bf16 main path": phi["launches"],
            f"{MAMBA.arch} bf16 main path": mamba["launches"], f"{DANUBE.arch} f32 check": danube_f32,
            f"{PHI.arch} f32 check": phi_f32, f"{MAMBA.arch} f32 check": mamba_f32,
            f"{HYBRID}-smoke f32 ServeEngine": hybrid,
            f"{HYBRID} ssm_block f32 (full width, chunk 256)": jamba_block["float32"],
            f"{HYBRID} ssm_block bf16 (full width, chunk 256)": jamba_block["bfloat16"],
            f"{VLM.arch} bf16 main path (make_prefill_step)": vlm["launches"],
            f"{VLM.arch} f32 check": vlm_f32,
            f"{ENCODER.arch} bf16 main path (make_encoder_step)": encoder["launches"],
            f"{ENCODER.arch} f32 check S={ENCODER.check_l}": encoder_f32[ENCODER.check_l],
            f"{ENCODER.arch} f32 check S={ENCODER_RAGGED_L}": encoder_f32[ENCODER_RAGGED_L], **tp_runs}

    def by_run(kernel: str) -> dict:
        return {run: counts[kernel] for run, counts in runs.items() if counts[kernel]}

    lines = [
        kernel_line("flash_attention", fa.TENSOR_CORE, "src/repro_torch/csrc/flash_attention_tc.cu",
                    flash_src, by_run("flash_attention_tc"), flash_rows[0]),
        kernel_line("flash_attention", fa.CUDA_CORE, "src/repro_torch/csrc/flash_attention.cu",
                    flash_src, by_run("flash_attention_cuda_core"), f32_row(flash_rows)),
        kernel_line("ssd_scan", ssd.TENSOR_CORE, "src/repro_torch/csrc/ssd_scan_tc.cu", ssd_src,
                    by_run("ssd_scan_tc"), ssd_rows[0]),
        kernel_line("ssd_scan", ssd.CUDA_CORE, "src/repro_torch/csrc/ssd_scan.cu", ssd_src,
                    by_run("ssd_scan_cuda_core"), f32_row(ssd_rows)),
    ]
    for line in lines[::2]:
        check(line["ms"] < line["previous_ms"],
              f"{line['name']} tensor-core kernel {line['ms']} ms is not faster than the "
              f"CUDA-core kernel's {line['previous_ms']} ms at the main-path shape")
    for rows, label in ((flash_rows, "flash_attention"), (ssd_rows, "ssd_scan")):
        worst = max(r["tol_share"] for r in rows)
        print(f"kernels: {label} ok on {len(rows)} shapes (worst share of the tolerance "
              f"{worst:.3f})", flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
