"""The harness: finds a cell of ``BENCHMARK.json`` and everything it names
by name, runs it once through its driver, reads its metrics and prints the
result line.

A cell (``workloads`` entry) names a configuration (``configs`` entry, whose
``file`` is a JSON file of sizes; its ``"reference"`` key names the plain
reference module under ``reference/``) and a traffic mix
(``traffic/<traffic>.json``, whose ``"kind"`` names the driver under
``drivers/``).  Its correctness limits are ``limits/<workload>.json``.
Every metric is ``metrics/<name>.py`` with a ``read(run)`` that returns a
number or None (nothing to read); a metric may list in ``ENTRIES`` the
port functions (``module:attribute``) it wants wrapped in a
``torch.profiler.record_function`` range during the traced sub-window.
A configuration of any layer pattern is its file (``layouts/__init__.py``),
with a layout module of its own where the built-in layout does not know
its layers.  A new cell, traffic mix, configuration or metric is new files
and a new entry: no file here changes.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, whole
NAME_CHARS = 120  # a device operation's name in the breakdown, cut to this many characters
ROOT_KEY = "_root"  # the checkout a configuration was read from, where its reference and layout are found


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and limits read in."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, os.path.basename(HERE))
    config = load_json(os.path.join(root, conf["file"]))
    config[ROOT_KEY] = root
    return dict(
        cell=cell,
        config=config,
        traffic=load_json(os.path.join(here, "traffic", cell["traffic"] + ".json")),
        limits=load_json(os.path.join(here, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])],
        per_layer=[m for m in bench["per_layer"] if workload in m.get("workloads", [workload])],
        root=root,
    )


def load_module(kind: str, name: str, root: str = ROOT):
    """``bench_port/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, os.path.basename(HERE), kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_port_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(spec: dict):
    return importlib.import_module("bench_port.drivers." + spec["traffic"]["kind"])


def arch_config(cfg: dict):
    """The port's configuration object of a configuration file: the keys
    that ``ArchConfig`` has, lists as tuples."""
    import dataclasses

    from repro_torch.models.config import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in fields})


def free_device(device: str) -> None:
    """Drop what nothing refers to any more and give the device its memory back."""
    import gc

    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def start_device(device: str) -> None:
    """Create the device's context now, so that set-up shows it as a phase of its own."""
    import torch

    if device == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize()


def reference_class(cfg: dict):
    """The plain reference the configuration names, from its checkout."""
    mod = load_module("reference", cfg["reference"], cfg.get(ROOT_KEY, ROOT))
    return getattr(mod, cfg["reference_class"])


class Run:
    """What one run recorded: set-up and window times, per-step or
    per-request records, counters, the traced sub-window's summary, and the
    checks with their limits."""

    def __init__(self, spec: dict, device: str):
        self.spec, self.device = spec, device
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.setup_s = self.window_s = 0.0
        self.steps: List[dict] = []  # training: one dict per step of the window
        self.batches: List[dict] = []  # serving: one dict per batch of the window
        self.requests: List[dict] = []  # serving: one dict per request of the window
        self.profile: Optional[dict] = None
        self.entry_calls: Dict[str, List[dict]] = {}
        self.checks: Dict[str, dict] = {}
        self.memory_peak_bytes = 0
        self.attempted = self.failed = 0
        self.notes: List[str] = []
        self.readings: Dict[str, dict] = {}  # each compared number, of the port and of the control
        self.phases: Dict[str, float] = {}  # set-up: seconds from the process's start to the end of each phase

    def mark(self, phase: str, t_start: float) -> None:
        self.phases[phase] = time.monotonic() - t_start

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = {"value": value, "limit": limit}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"] for c in self.checks.values())


# ---------------------------------------------------------------------------
# The traced sub-window
# ---------------------------------------------------------------------------
def _resolve(entry: str):
    mod, attr = entry.split(":")
    return importlib.import_module(mod), attr


def _describe(args, kwargs) -> dict:
    import torch

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return dict(
        shapes=[list(t.shape) for t in tensors],
        dtype=str(tensors[0].dtype).replace("torch.", "") if tensors else None,
        kwargs={k: v for k, v in kwargs.items() if isinstance(v, (int, float, bool, str, type(None)))},
    )


@contextlib.contextmanager
def wrapped_entries(run: Run, entries: List[str]):
    """Each port function ``module:attribute`` in a record_function range
    named ``bench_port::<attribute>``, its calls' shapes kept in
    ``run.entry_calls``; the originals put back on exit."""
    import torch

    saved = []
    for entry in entries:
        mod, attr = _resolve(entry)
        orig = getattr(mod, attr)
        calls = run.entry_calls.setdefault(attr, [])

        def wrapper(*args, _orig=orig, _attr=attr, _calls=calls, **kwargs):
            _calls.append(_describe(args, kwargs))
            with torch.profiler.record_function("bench_port::" + _attr):
                return _orig(*args, **kwargs)

        saved.append((mod, attr, orig))
        setattr(mod, attr, functools.wraps(orig)(wrapper))
    try:
        yield
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def profile(run: Run, fn: Callable[[], None]) -> None:
    """Trace ``fn`` (a few steps or batches) with torch.profiler and keep
    the summary in ``run.profile``: busy and window seconds, the device
    operations that took most time, the longest idle gaps by the host
    operations running when each began and when it ended (the two innermost
    of each), and each wrapped entry's device seconds."""
    import torch
    from torch.profiler import ProfilerActivity

    from bench_port.frozen.roofline import gaps, union_s

    entries = sorted({e for m in run.spec["per_layer"]
                      for e in getattr(metric(m["name"], run.spec["root"]), "ENTRIES", [])})
    run.entry_calls = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device == "cuda" else [])
    if run.device == "cuda":
        torch.cuda.synchronize()
    with wrapped_entries(run, entries):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            if run.device == "cuda":
                torch.cuda.synchronize()
    events = prof.events()
    dev, cpu, annotated = [], [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            cpu.append(e)
        elif e.name.startswith("bench_port::") or getattr(e, "is_user_annotation", False):
            annotated.append(e)  # a range's span on the device timeline: no operation of its own
        else:
            dev.append(e)
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name: Dict[str, float] = {}
    for e in dev:
        name = e.name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    # an entry's device seconds: the span on the device of each of its
    # ranges, from the first kernel launched inside to the last one's end
    ranges: Dict[str, float] = {}
    for e in annotated:
        if e.name.startswith("bench_port::"):
            key = e.name[len("bench_port::"):]
            ranges[key] = ranges.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    summary = dict(busy_s=0.0, window_s=0.0, device_ops=[], idle_gaps=[], ranges=ranges, kernels=by_name)
    if intervals:
        summary["busy_s"] = union_s(intervals) / 1e6
        summary["window_s"] = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e6
        summary["device_ops"] = [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        longest = sorted(gaps(intervals), key=lambda g: g[0] - g[1])[:10]
        summary["idle_gaps"] = [[f"{_host_op_at(cpu, s)} -> {_host_op_at(cpu, e)}", (e - s) / 1e6] for s, e in longest]
    run.profile = summary


def _host_op_at(cpu_events, t_us: float) -> str:
    """The two innermost host operations running at ``t_us``, outer first."""
    around = [e for e in cpu_events if e.time_range.start <= t_us <= e.time_range.end]
    around.sort(key=lambda e: e.time_range.elapsed_us())
    return " > ".join(e.name for e in reversed(around[:2])) or "no host operation"


# ---------------------------------------------------------------------------
# Metrics and the result line
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def metric(name: str, root: str = ROOT):
    return load_module("metrics", name, root)


def read_metrics(run: Run, entries: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = metric(m["name"], run.spec["root"]).read(run)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run; left out", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    modules = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in list(modules)} & set(FORBIDDEN))


def device_info(run: Run, count: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu"
    info = dict(platform="gpu" if run.device == "cuda" else "cpu", kind=kind, count=count,
                memory_peak_bytes=int(run.memory_peak_bytes))
    if run.profile is not None:
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["window_s"]
    return info


def result(run: Run, trace: bool, chips: int) -> dict:
    spec = run.spec
    metrics = read_metrics(run, spec["per_layer"] if trace else spec["end_to_end"])
    out = dict(correct=run.correct, attempted=run.attempted, failed=run.failed,
               metrics=metrics, device=device_info(run, chips))
    if trace and run.profile is not None:
        out["breakdown"] = dict(device_ops=run.profile["device_ops"], idle_gaps=run.profile["idle_gaps"])
    out["checks"] = run.checks
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: Optional[float] = None, root: str = ROOT, **options) -> Run:
    """One run of a cell on ``device``: set-up, window, traced sub-window
    (``trace``), then the check against the reference."""
    t_start = time.monotonic() if t_start is None else t_start
    spec = load_cell(workload, root)
    return driver(spec).run(spec, seed, seconds, trace, device, t_start, **options)


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    import torch

    t_start = time.monotonic() if t_start is None else t_start
    t_torch = time.monotonic() - t_start  # the end of torch's import
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); {have} available", file=sys.stderr)
        return 2
    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    run.phases = {"torch": t_torch, **run.phases}
    line = result(run, bool(args.trace), chips)
    bad = loaded_forbidden()
    if bad:
        print(f"modules that the benchmark may not load were loaded: {bad}", file=sys.stderr)
        return 3
    for note in run.notes:
        print(note, file=sys.stderr)
    print("set-up phases, seconds from the process's start: "
          + ", ".join(f"{k} {v:.3f}" for k, v in run.phases.items()), file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
