"""Step-atomic checkpointing of (params, optimizer, data-plane cursor): the
port of ``repro.training.checkpoint``, on the same disk layout, so a
checkpoint written by either package restores in the other.  (The reference
can also store a JAX RNG key under ``rng``; the port's training draws no
random numbers after initialisation, so it has none to store.)

Layout: one directory per step —

    <dir>/step_000123/
        manifest.json    keys + dtypes + loader state + metadata
        arrays.npz       flat leaves keyed by tree path

Keys are the reference's "/"-joined tree paths over ``{"params", "opt"}``,
in its tree layout: per-period parameters and
moments stacked over periods (``repro_torch.weights.reference_key``).  A
bf16 leaf is stored as the reference stores it: its raw 2-byte values in a
void (``V2``) array, with ``"bfloat16"`` in the manifest's dtypes — numpy has
no bfloat16 of its own, and this needs neither JAX nor ``ml_dtypes``.

Writes are ATOMIC (tmp dir + os.rename) so a preempted node never leaves a
half-written checkpoint, and ``latest_step`` only believes a directory that
contains a manifest.  ``AsyncCheckpointer.save`` copies the tensors to host
memory synchronously, then writes on a worker thread.

A ``ShardedLM`` and its sharded moments save to the same layout: every rank
gathers each whole leaf in turn, rank 0 copies it to the host and writes,
and the others wait at a barrier (``save_checkpoint`` only).  ``restore_checkpoint(like=(sharded, opt))``
copies each rank's own slices, so a checkpoint crosses between one process
and a mesh of ranks both ways.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedLM
from repro_torch.weights import reference_key, stack_by_reference_key

_BF16 = "bfloat16"


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 as its raw bits in a ``V2`` array.  It is
    a copy for a CPU tensor too (``.cpu()`` would return the tensor itself),
    so training that goes on in place cannot reach an asynchronous write."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The CPU tensor a stored array holds (``dtype`` from the manifest)."""
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(params, opt_state, keep: bool = True) -> Tuple[Dict, Dict]:
    """(arrays, dtypes) by reference key for a model and its optimizer state.
    Each leaf is made whole (``params.whole``: a ``ShardedLM`` gathers it, and
    every rank of its group must call) and copied to the host before the
    next, so the device never holds more than one whole leaf beyond the
    model; with ``keep`` False (a rank that does not write) nothing is
    copied to the host."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    def put(prefix: str, named) -> None:
        kinds, hosted = {}, []
        for n, t in named:
            kinds["/".join(reference_key(n)[0])] = str(t.dtype).replace("torch.", "")
            whole = params.whole(n, t)
            if keep:
                hosted.append((n, _host(whole)))
            del whole
        for path, a in stack_by_reference_key(hosted, lambda a: a).items():
            key = "/".join(path)
            arrays[f"{prefix}/{key}"] = a
            dtypes[f"{prefix}/{key}"] = kinds[key]

    put("params", params.named_parameters())
    put("opt/m", opt_state["m"].items())
    put("opt/v", opt_state["v"].items())
    if keep:
        arrays["opt/step"] = _host(opt_state["step"])
        dtypes["opt/step"] = "int32"
    return arrays, dtypes


def _write(directory, step: int, arrays: Dict, dtypes: Dict, loader_state, extra) -> str:
    base = pathlib.Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix=".tmp_ckpt_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "dtypes": dtypes,
            "loader_state": loader_state or {},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(final)


def save_checkpoint(
    directory: str,
    step: int,
    params,
    opt_state,
    loader_state: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> str:
    """Synchronous atomic save of a ``DecoderLM`` and its optimizer state;
    returns the checkpoint path.  For a ``ShardedLM`` every rank of the
    group calls it: rank 0 writes, and every rank returns once it has."""
    if not isinstance(params, ShardedLM):
        return _write(directory, step, *_flatten(params, opt_state), loader_state, extra)
    import torch.distributed as dist

    writes = dist.get_rank() == 0
    arrays, dtypes = _flatten(params, opt_state, keep=writes)
    path = str(pathlib.Path(directory) / f"step_{step:08d}")
    if writes:
        path = _write(directory, step, arrays, dtypes, loader_state, extra)
    dist.barrier()
    return path


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with training compute.

    ``save()`` copies the tensors to host memory synchronously, then writes
    on a background thread; ``wait()`` joins before the next save or at
    shutdown so at most one write is in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def save(self, step: int, params, opt_state, loader_state=None, extra=None):
        if isinstance(params, ShardedLM):
            raise TypeError("a ShardedLM saves through save_checkpoint (rank 0 writes)")
        self.wait()
        arrays, dtypes = _flatten(params, opt_state)

        def work():
            try:
                self.last_path = _write(self.directory, step, arrays, dtypes, loader_state, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = list_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(
                pathlib.Path(self.directory) / f"step_{s:08d}", ignore_errors=True
            )


def list_steps(directory: str):
    base = pathlib.Path(directory)
    if not base.exists():
        return []
    out = []
    for d in base.iterdir():
        m = re.fullmatch(r"step_(\d+)", d.name)
        if m and (d / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(
    directory: str,
    step: Optional[int] = None,
    like: Optional[Tuple] = None,
) -> Tuple[Any, Any, dict, dict]:
    """Returns (params, opt_state, loader_state, extra).

    ``like`` = (model, opt_state): every parameter, moment and the step are
    copied into them in place, by key path, and they are returned; for a
    ``ShardedLM``, each rank's slices of them.  Without
    it, params and opt_state are flat dicts of CPU tensors keyed by their
    paths under ``params/`` and ``opt/`` (stacked leaves stay stacked)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = {k: _tensor(z[k], manifest["dtypes"][k]) for k in z.files}

    def leaf(prefix: str, name: str) -> torch.Tensor:
        key_path, period = reference_key(name)
        t = arrays[prefix + "/" + "/".join(key_path)]
        return t if period is None else t[period]

    if like is not None:
        model, opt = like

        def mine(prefix: str, name: str) -> torch.Tensor:
            return leaf(prefix, name)[model.slices(name)]

        for name, p in model.named_parameters():
            p.copy_(mine("params", name))
        for kind in ("m", "v"):
            for name, t in opt[kind].items():
                t.copy_(mine(f"opt/{kind}", name))
        opt["step"].copy_(arrays["opt/step"])
        params = model
    else:
        params = {k[len("params/"):]: v for k, v in arrays.items() if k.startswith("params/")}
        opt = {k[len("opt/"):]: v for k, v in arrays.items() if k.startswith("opt/")}
    return params, opt, manifest.get("loader_state", {}), manifest.get("extra", {})
