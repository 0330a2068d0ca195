"""Ablations of the bf16 flash kernel on the card: what each design element
of ``csrc/flash_attention_tc.cu`` is worth, and what still holds it.

    python -m repro_torch.kernels.probe        # on a CUDA machine, from the checkout's root

Each variant is a copy of the source with one element changed by a text
substitution, built by nvcc with the package's flags beside the source as
it is (all builds started together, under ``build/kernels/probe``).  Every
variant is timed at the main paths' shapes through its C entry, so no Python
wrapper sits in the timed loop, in turns with the kernel as built (base,
variant, variant, base; CUDA events over 30 calls each).  A variant that
keeps the function is also held against ``flash_attention_plain`` at 2e-2;
one marked "timing only" computes a wrong result on purpose and is not.
Two shapes read danube's and hubert's rows from views into 256-byte rows
(q/k/v sliced from tensors of head_dim 128): the cost of their 240- and
160-byte rows to TMA.  Prints one JSON line a shape.  Nothing here runs at
import time, and the port never calls it.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

from repro_torch.kernels import _build

SOURCE = "flash_attention_tc"
_STORE = ("for (int p = 0; p < NP; ++p) "
          "tc::tma_store_4d(&to, Qc + p * PANEL, p * 64, w.h, rq0, w.b);")
# name: (substitutions, keeps the function)
VARIANTS = {
    "no_pingpong": ([("tc::bar_sync(BAR_SCHED + c, 256);", ""),
                     ("tc::bar_arrive(BAR_SCHED + 1 - c, 256);", ""),
                     ("if (c == 1) tc::bar_arrive(BAR_SCHED, 256);", "")], True),
    "block_per_tile": ([("const int grid = (int)(total < sms ? total : sms);",
                         "const int grid = (int)total;")], True),
    "no_o_store": ([(_STORE, "")], False),
    "no_exp2": ([("exp2f(fmaf(s[i], scale_log2, m_neg[(i & 3) >> 1]))",
                  "fmaf(s[i], scale_log2, m_neg[(i & 3) >> 1])")], False),
}
# label, B, S, H, KV, hd, causal, window, row width the views are cut from
SHAPES = [
    ("danube prefill", 4, 1024, 32, 8, 120, True, 4096, 120),
    ("danube prefill, 256-byte rows", 4, 1024, 32, 8, 120, True, 4096, 128),
    ("phi3.5-moe prefill", 4, 1024, 32, 8, 128, True, None, 128),
    ("phi-3-vision prefill", 4, 1024, 32, 32, 96, True, None, 96),
    ("hubert encode", 8, 1024, 16, 16, 80, False, None, 80),
    ("hubert encode, 256-byte rows", 8, 1024, 16, 16, 80, False, None, 128),
    ("a rank's 16 / 4", 4, 1024, 16, 4, 120, True, 4096, 120),
    ("deepseek run 14 / 2", 4, 1024, 14, 2, 128, True, None, 128),
    ("deepseek run 5 / 1", 4, 1024, 5, 1, 128, True, None, 128),
]


def build_variants() -> dict:
    """{name: C entry} for the source as it is ("base") and each variant."""
    text = (_build.CSRC / f"{SOURCE}.cu").read_text()
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (subs, _) in {"base": ([], True), **VARIANTS}.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{SOURCE}.cu")
            src = src.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        if "C7515" in log:
            print(f"variant {name}: ptxas serialises wgmma (C7515)", flush=True)
        fn = ctypes.CDLL(str(so)).flash_attention_tc_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain

    if not torch.cuda.is_available():
        sys.exit("the probe times kernels on a CUDA card; none is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    fns = build_variants()
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, q, k, v, out, causal, window):
        B, Sq, H, hd = q.shape
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], H,
                k.shape[2], hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
                -1 if window is None else window, hd ** -0.5, stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention_tc_fwd returned {rc}")

    def finish(what, deadline_s=30.0):  # a variant that hangs ends the run, not the card
        done = torch.cuda.Event()
        done.record()
        t0 = time.monotonic()
        while not done.query():
            if time.monotonic() - t0 > deadline_s:
                print(f"probe: {what} did not finish in {deadline_s} s", flush=True)
                os._exit(3)
            time.sleep(0.001)

    def time_ms(fn, what, iters=30):
        fn()
        finish(what)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        finish(what)
        return start.elapsed_time(end) / iters

    g = torch.Generator(device="cuda").manual_seed(3)
    for label, B, S, H, KV, hd, causal, window, width in SHAPES:
        q, k, v = (torch.randn(B, S, n, width, generator=g, device="cuda").bfloat16()[..., :hd]
                   for n in (H, KV, KV))
        out = torch.empty(B, S, H, hd, device="cuda", dtype=torch.bfloat16)
        want = flash_attention_plain(q, k, v, causal=causal, window=window).float()
        row = {"shape": label, "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "row_elems": width}
        for name, fn in fns.items():
            run = lambda fn=fn: call(fn, q, k, v, out, causal, window)  # noqa: E731
            if name == "base" or VARIANTS[name][1]:
                run()
                finish(f"{name} at {label}")
                share = ((out.float() - want).abs() / (2e-2 + 2e-2 * want.abs())).max().item()
                if not share <= 1.0:
                    raise RuntimeError(f"{name} disagrees with plain at {label}: share {share}")
            if name == "base":
                continue
            base = lambda: call(fns["base"], q, k, v, out, causal, window)  # noqa: E731
            a, b, c, d = (time_ms(f, f"{n} at {label}")
                          for f, n in ((base, "base"), (run, name), (run, name), (base, "base")))
            row[name] = (b + c) / 2
            row.setdefault("base_ms", []).append((a + d) / 2)
        row["base_ms"] = sum(row["base_ms"]) / len(row["base_ms"])
        print("probe " + json.dumps(row), flush=True)
        del q, k, v, out, want


if __name__ == "__main__":
    main()
