"""Ablations of the bf16 tensor-core kernels on the card: what each design
element of ``csrc/flash_attention_tc.cu`` and ``csrc/ssd_scan_tc.cu`` is
worth, and what still holds them.

    python -m repro_torch.kernels.probe            # flash; on a CUDA card, from the checkout
    python -m repro_torch.kernels.probe ssd        # the SSD scan
    python -m repro_torch.kernels.probe ssd --steps  # the SSD scan's cycles a step
    python -m repro_torch.kernels.probe --fetch-parent REV   # in a git checkout, no card needed

Each variant is a copy of the source with one element changed by a text
substitution, built by nvcc with the package's flags beside the source as
it is (all builds started together, under ``build/kernels/probe``).  Every
variant is timed at the main paths' shapes through its C entry, so no Python
wrapper sits in the timed loop, in turns with the kernel as built (base,
variant, variant, base; CUDA events over 30 calls each, 20 for the SSD
scan).  A variant that keeps the function is also held against the plain
version at 2e-2; one marked "timing only" computes a wrong result on
purpose and is not.  A variant that hangs ends the run after 30 s.  Prints
one JSON line a shape.  Nothing here runs at import time, and the port
never calls it.

Flash: two shapes read danube's and hubert's rows from views into 256-byte
rows (q/k/v sliced from tensors of head_dim 128): the cost of their 240-
and 160-byte rows to TMA.

SSD: the variants are the design's three levers taken away (one block
walking one chain, the chunk-serial order; the wait for the handed-on
state moved before every product; one TMA stage), two timing-only ones
(no gpu-scope fence before a flag; no y stores), and ``parent``, the
tensor-core kernel this design replaced: ``--fetch-parent REV`` copies
``csrc/ssd_scan_tc.cu`` and the ``tc_ops.cuh`` it includes as they were at
git revision REV to ``build/kernels/probe/parent/``, and ``ssd`` builds and
times it there where those files exist.  Each call of the new kernel through its C entry zeroes
its flags first, as the wrapper does.  ``ssd --steps`` builds the source
with ``-DSSD_STEP_CLOCKS`` and prints, a shape, the median SM cycles of
each step of block 0's units (``clock64`` stamps), for each consumer
warpgroup and the producer warp.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

from repro_torch.kernels import _build

FLASH = "flash_attention_tc"
_STORE = ("for (int p = 0; p < NP; ++p) "
          "tc::tma_store_4d(&to, Qc + p * PANEL, p * 64, w.h, rq0, w.b);")
# name: (substitutions, keeps the function)
FLASH_VARIANTS = {
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
FLASH_SHAPES = [
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

SSD = "ssd_scan_tc"
_CLAIM = ("    if (lane == 0) u = atomicAdd(a.flags + 2 * a.n_chains, 1);\n"
          "    u = __shfl_sync(0xffffffffu, u, 0);")
_WAIT = "      if (half == 1) flag_wait();  // the predecessor's flag, under U\n"
_STEP1 = "    // 1. U = (w o x)^T B[:, 64 C ..] from zero"
SSD_VARIANTS = {
    "chain_per_block": ([(_CLAIM, "    u = k < a.T ? k * a.n_chains + (int)blockIdx.x : a.total;"),
                         ("  const int grid = a.total < sms ? a.total : sms;",
                          "  const int grid = a.n_chains;")], True),
    "early_wait": ([(_WAIT, ""), (_STEP1, "    flag_wait();\n" + _STEP1)], True),
    "one_stage": ([("constexpr int STAGES = 2;", "constexpr int STAGES = 1;")], True),
    "no_fence": ([("        __threadfence();\n        st_relaxed(", "        st_relaxed(")], False),
    "no_y_store": ([("        *reinterpret_cast<uint32_t*>(row + p) =",
                     "        if (xv.x == 1e30f) *reinterpret_cast<uint32_t*>(row + p) =")], False),
}
# the steps the kernel stamps (csrc/ssd_scan_tc.cu STEP), and what comes between them
SSD_CONSUMER_STEPS = ["U", "hand-off", "S operand", "C B^T, M, M x", "C S^T", "y out",
                      "wait for a stage"]
SSD_PRODUCER_STEPS = ["claim, loads issued", "a_cum", "w, e, decay", "wait for a stage"]
# label, B, S, H, P, G, N, chunk; x, B and C slices of one xBC, as the models hand them
SSD_SHAPES = [
    ("mamba prefill", 8, 2048, 24, 64, 1, 128, 128),
    ("jamba layer, chunk 256", 1, 8192, 256, 64, 1, 128, 256),
    ("a rank's 128 jamba heads", 1, 8192, 128, 64, 1, 128, 256),
]
PARENT_SSD = _build.BUILD_DIR / "probe" / "parent" / f"{SSD}.cu"  # tc_ops.cuh beside it


def _argtypes(source: str, parent: bool = False) -> list:
    if source == FLASH:
        return ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    pointers = 8 if parent else 10  # the parent takes no ring and no flags
    return [ctypes.c_void_p] * pointers + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12 + [
        ctypes.c_void_p]


def build_variants(source: str, variants: dict, extra: dict = None, flags=()) -> dict:
    """{name: C entry} for the source as it is ("base"), each variant, and
    each of ``extra`` ({name: path of a whole source, the parent's C entry,
    built where it lies, so its own headers beside it come first}), each
    built with the package's flags and ``flags``."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for name, (subs, _) in {"base": ([], True), **variants}.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{source}.cu")
            src = src.replace(old, new)
        srcs[name] = src
    procs = {}
    for name, src in {**srcs, **(extra or {})}.items():
        so = out / f"{source}_{name}.so"
        if name in srcs:
            cu = out / f"{source}_{name}.cu"
            cu.write_text(src)
        else:
            cu = src
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, f"-I{_build.CSRC}", "-o", str(so),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        if "C7515" in log:
            print(f"variant {name}: ptxas serialises wgmma (C7515)", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"{source}_fwd")
        fn.argtypes = _argtypes(source, parent=name in (extra or {}))
        fn.restype = ctypes.c_int
        fn.lib = lib
        fns[name] = fn
    return fns


def _finish(what, deadline_s=30.0):
    """Wait for the work queued so far; a variant that hangs ends the run,
    not the card."""
    import torch

    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > deadline_s:
            print(f"probe: {what} did not finish in {deadline_s} s", flush=True)
            os._exit(3)
        time.sleep(0.001)


def _time_ms(fn, what, iters):
    import torch

    fn()
    _finish(what)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    _finish(what)
    return start.elapsed_time(end) / iters


def _in_turns(row, fns, runs, label, iters):
    """Each variant against the base, base / variant / variant / base."""
    for name in fns:
        if name == "base":
            continue
        a, b, c, d = (_time_ms(runs[n], f"{n} at {label}", iters)
                      for n in ("base", name, name, "base"))
        row[name] = (b + c) / 2
        row.setdefault("base_ms", []).append((a + d) / 2)
    row["base_ms"] = sum(row["base_ms"]) / len(row["base_ms"])


def probe_flash(stream) -> None:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain

    fns = build_variants(FLASH, FLASH_VARIANTS)

    def call(fn, q, k, v, out, causal, window):
        B, Sq, H, hd = q.shape
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], H,
                k.shape[2], hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
                -1 if window is None else window, hd ** -0.5, stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention_tc_fwd returned {rc}")

    g = torch.Generator(device="cuda").manual_seed(3)
    for label, B, S, H, KV, hd, causal, window, width in FLASH_SHAPES:
        q, k, v = (torch.randn(B, S, n, width, generator=g, device="cuda").bfloat16()[..., :hd]
                   for n in (H, KV, KV))
        out = torch.empty(B, S, H, hd, device="cuda", dtype=torch.bfloat16)
        want = flash_attention_plain(q, k, v, causal=causal, window=window).float()
        row = {"shape": label, "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "row_elems": width}
        runs = {name: (lambda fn=fn: call(fn, q, k, v, out, causal, window))
                for name, fn in fns.items()}
        for name in fns:
            if name == "base" or FLASH_VARIANTS[name][1]:
                runs[name]()
                _finish(f"{name} at {label}")
                share = ((out.float() - want).abs() / (2e-2 + 2e-2 * want.abs())).max().item()
                if not share <= 1.0:
                    raise RuntimeError(f"{name} disagrees with plain at {label}: share {share}")
        _in_turns(row, fns, runs, label, 30)
        print("probe " + json.dumps(row), flush=True)
        del q, k, v, out, want


def _ssd_case(g, B, S, H, P, G, N, chunk, stream):
    """Inputs at a shape (x, B and C slices of one xBC), the plain version's
    outputs, and ``call(fn, parent)`` through a C entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ssd

    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g, device="cuda").bfloat16()
    x, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, Bm, Cm = x.reshape(B, S, H, P), Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N)
    dt = F.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    D = torch.ones(H, device="cuda")
    y = torch.empty(B, S, H, P, device="cuda", dtype=torch.bfloat16)
    state = torch.empty(B, H, P, N, device="cuda")
    chains = B * H * -(-P // ssd.P_TILE)
    ring = torch.empty(chains * ssd.RING_FLOATS, device="cuda")
    flags = torch.zeros(2 * chains + 1, dtype=torch.int32, device="cuda")
    want = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=chunk)
    tail = (B, S, H, P, G, N, chunk, ssd.ssd_tile(chunk, N), *x.stride()[:3], *dt.stride(),
            *Bm.stride()[:3], *Cm.stride()[:3], stream)
    head = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), y.data_ptr(), state.data_ptr())

    def call(fn, parent=False):
        if not parent:
            flags.zero_()
        rc = fn(*head, *tail) if parent else fn(*head, ring.data_ptr(), flags.data_ptr(), *tail)
        if rc != 0:
            raise RuntimeError(f"ssd_scan_tc_fwd returned {rc}")

    keep = (xbc, dt, A, D, ring, flags)  # alive as long as the case
    return (y, state), want, call, keep


def probe_ssd(stream) -> None:
    import torch

    extra = {"parent": PARENT_SSD} if PARENT_SSD.exists() else {}
    if not extra:
        print(f"probe: no {PARENT_SSD}: the parent is not timed (--fetch-parent REV)", flush=True)
    fns = build_variants(SSD, SSD_VARIANTS, extra)
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, B, S, H, P, G, N, chunk in SSD_SHAPES:
        (y, state), (want_y, want_st), call, _keep = _ssd_case(g, B, S, H, P, G, N, chunk, stream)
        runs = {name: (lambda fn=fn, p=name in extra: call(fn, p)) for name, fn in fns.items()}
        row = {"shape": label, "B": B, "S": S, "H": H, "P": P, "N": N, "chunk": chunk}
        for name in fns:
            if name in SSD_VARIANTS and not SSD_VARIANTS[name][1]:
                continue  # timing only
            runs[name]()
            _finish(f"{name} at {label}")
            share = max(((got.float() - ref.float()).abs() / (2e-2 + 2e-2 * ref.float().abs()))
                        .max().item() for got, ref in ((y, want_y), (state, want_st)))
            if not share <= 1.0:
                raise RuntimeError(f"{name} disagrees with plain at {label}: share {share}")
        _in_turns(row, fns, runs, label, 20)
        print("probe " + json.dumps(row), flush=True)
        del y, state, want_y, want_st, call, _keep


def probe_ssd_steps(stream) -> None:
    """The median SM cycles of each step of block 0's units, a shape."""
    import statistics

    import torch

    fn = build_variants(SSD, {}, flags=("-DSSD_STEP_CLOCKS",))["base"]
    getter = fn.lib.ssd_scan_tc_step_clocks
    getter.argtypes, getter.restype = [ctypes.c_void_p], ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, B, S, H, P, G, N, chunk in SSD_SHAPES:
        _, _, call, _keep = _ssd_case(g, B, S, H, P, G, N, chunk, stream)
        for _ in range(3):  # the last launch's stamps
            call(fn)
            _finish(f"the stamped kernel at {label}")
        stamps = (ctypes.c_longlong * (3 * 64 * 8))()
        if getter(stamps) != 0:
            raise RuntimeError("ssd_scan_tc_step_clocks failed")
        row = {"shape": label}
        for who, names in ((0, SSD_CONSUMER_STEPS), (1, SSD_CONSUMER_STEPS),
                           (2, SSD_PRODUCER_STEPS)):
            n = len(names)  # stamps 0 .. n - 1, then the next unit's 0
            units = [[stamps[(who * 64 + k) * 8 + i] for i in range(n)] for k in range(64)]
            units = [t for t in units if all(t)]
            steady = range(2, len(units) - 2)  # neither the first units nor the tail
            cycles = {name: statistics.median(
                (units[k + 1][0] if i == n - 1 else units[k][i + 1]) - units[k][i]
                for k in steady) for i, name in enumerate(names)}
            key = "producer" if who == 2 else f"consumer {who}"
            row[key] = {"units": len(units), "cycles a unit": statistics.median(
                units[k + 1][0] - units[k][0] for k in steady), **cycles}
        print("probe steps " + json.dumps(row), flush=True)
        del call, _keep


def fetch_parent(rev: str) -> None:
    """``csrc/ssd_scan_tc.cu`` and ``csrc/tc_ops.cuh`` at git revision
    ``rev``, into the build directory."""
    PARENT_SSD.parent.mkdir(parents=True, exist_ok=True)
    for name in (f"{SSD}.cu", "tc_ops.cuh"):
        src = subprocess.run(["git", "show", f"{rev}:src/repro_torch/csrc/{name}"],
                             capture_output=True, text=True, check=True).stdout
        (PARENT_SSD.parent / name).write_text(src)
    print(f"probe: {rev}'s csrc/{SSD}.cu and tc_ops.cuh -> {PARENT_SSD.parent}", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--fetch-parent"] and len(argv) == 2:
        return fetch_parent(argv[1])
    if argv not in ([], ["ssd"], ["ssd", "--steps"]):
        sys.exit("usage: python -m repro_torch.kernels.probe [ssd [--steps] | --fetch-parent REV]")
    import torch

    if not torch.cuda.is_available():
        sys.exit("the probe times kernels on a CUDA card; none is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    {(): probe_flash, ("ssd",): probe_ssd, ("ssd", "--steps"): probe_ssd_steps}[tuple(argv)](stream)


if __name__ == "__main__":
    main()
