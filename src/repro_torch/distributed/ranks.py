"""Rank groups, each rank in a process of its own: the one launcher the tests
and ``chip_smoke.py`` share.

    results = run_ranks(fn, world=4, args=(...,))                 # on the card
    results = run_ranks(fn, world=4, args=(...,), device="cpu")   # on the CPU

starts ``world`` child interpreters, rank r on card ``r % device_count``
unless the caller asks for the CPU.  Each joins one process group through a
file store in a new temporary directory (no TCP port, so two groups started
at once never meet), runs ``fn(rank, world, *args)`` and writes the dict of
numpy arrays it returns to a file; ``run_ranks`` returns the dicts by rank.
The caller's process never joins a group and keeps its environment: a
child gets ``OMP_NUM_THREADS=1``, one torch thread, the caller's
``sys.path`` as its ``PYTHONPATH`` and the ``env`` it is given.  If a child
fails, or the group outlives ``timeout_s``, every child is killed and
``run_ranks`` raises with the failing rank's last lines of stderr.

``fn`` is found again in the child by its module and qualified name, or by
its file where its module is ``__main__``: a module-level function.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Callable, Dict, List, Optional

import numpy as np

_TAIL = 4000  # bytes of a failing rank's stderr in the error


def run_ranks(
    fn: Callable[..., Dict[str, np.ndarray]],
    world: int,
    *,
    args: tuple = (),
    backend: str = "gloo",
    device: str = "cuda",
    timeout_s: float = 120.0,
    env: Optional[Dict[str, str]] = None,
) -> List[Dict[str, np.ndarray]]:
    """Run ``fn(rank, world, *args)`` in ``world`` processes of one group and
    return each rank's dict of arrays, in rank order.  ``device="cuda"``, the
    default, puts rank r on card ``r % device_count`` before the group
    starts; ``device="cpu"`` leaves the ranks on the CPU."""
    if "<locals>" in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__}: a rank function must be defined at module level")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    procs: List[subprocess.Popen] = []
    try:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        job = dict(module=fn.__module__, file=os.path.abspath(sys.modules[fn.__module__].__file__),
                   qualname=fn.__qualname__, world=world, backend=backend, device=device,
                   timeout_s=timeout_s, dir=tmp)
        with open(os.path.join(tmp, "job.json"), "w") as f:
            json.dump(job, f)
        child_env = dict(os.environ, OMP_NUM_THREADS="1",
                         PYTHONPATH=os.pathsep.join(p for p in sys.path if p), **(env or {}))
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.txt"), "wb") as out, \
                    open(os.path.join(tmp, f"err{r}.txt"), "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.distributed.ranks", tmp, str(r)],
                    stdout=out, stderr=err, env=child_env))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(f"rank {r} of {world} exited with {codes[r]}:\n{_tail(tmp, r)}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank group of {world} ran past {timeout_s} s; rank 0:\n"
                                   f"{_tail(tmp, 0)}")
            time.sleep(0.05)
        results = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                results.append({k: z[k] for k in z.files})
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _tail(tmp: str, rank: int) -> str:
    with open(os.path.join(tmp, f"err{rank}.txt"), "rb") as f:
        return f.read()[-_TAIL:].decode("utf-8", "replace")


def _resolve(job: dict) -> Callable:
    if job["module"] == "__main__":
        spec = importlib.util.spec_from_file_location("_rank_main", job["file"])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(job["module"])
    fn = mod
    for part in job["qualname"].split("."):
        fn = getattr(fn, part)
    return fn


def _child(tmp: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    with open(os.path.join(tmp, "job.json")) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    if job["device"] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks(device='cuda'): no CUDA card here; pass device='cpu' to run "
                               "the ranks on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        job["backend"], init_method="file://" + os.path.join(tmp, "store"), rank=rank,
        world_size=job["world"], timeout=timedelta(seconds=job["timeout_s"]))
    try:
        fn = _resolve(job)
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)  # written by run_ranks in the parent
        out = fn(rank, job["world"], *args)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
