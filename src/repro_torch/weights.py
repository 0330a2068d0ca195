"""Carry parameters and optimizer state between the reference's tree and the
port's model.

The reference keeps parameters as a nested dict with ``stack/pos{i}`` leaves
that carry a leading ``n_periods`` axis; ``jax.tree.map(np.asarray, params)``
turns it into numpy arrays.  ``params_from_reference`` builds a
``DecoderLM`` from such a tree by key path (a copy, never a transpose: both
keep the ``(in, out)`` orientation), and ``params_to_numpy`` is the inverse.
The optimizer state's moments follow the same key paths under ``m`` and
``v`` (``opt_state_from_reference`` / ``opt_state_to_numpy``).

numpy has no bfloat16 of its own: a bf16 leaf arrives as whatever dtype
numpy was given (``ml_dtypes.bfloat16`` from JAX) and is read through f32,
which is exact; ``params_to_numpy`` returns bf16 leaves as f32 arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import DecoderLM, resolve_device


def reference_key(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference key path of a port parameter name, and its period
    index: ``layers.{p}.pos{i}.mixer.wq`` is ``stack/pos{i}/mixer/wq[p]``;
    a name outside the stack keeps its path and has no period (None)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("stack", *parts[2:]), int(parts[1])
    return tuple(parts), None


def stack_by_reference_key(
    named: Iterable[Tuple[str, torch.Tensor]], host: Callable[[torch.Tensor], np.ndarray]
) -> Dict[Tuple[str, ...], np.ndarray]:
    """Host arrays by reference key path, the per-period tensors stacked
    along a leading axis (in period order, which ``named_parameters`` keeps)."""
    flat: Dict[Tuple[str, ...], list] = {}
    for name, t in named:
        path, period = reference_key(name)
        flat.setdefault(path, []).append(host(t))
    return {path: np.stack(a) if path[0] == "stack" else a[0] for path, a in flat.items()}


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    out: Dict = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def _lookup(tree: Dict, name: str) -> np.ndarray:
    """The reference leaf (or its period's slice) for a port parameter."""
    path, period = reference_key(name)
    for key in path:
        tree = tree[key]
    return tree if period is None else tree[period]


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of the caller's buffer)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(
    np_tree: Dict, cfg: ArchConfig, device=None, trainable: bool = False
) -> DecoderLM:
    """The reference's parameter tree (numpy leaves) as the port's model on
    ``device`` (the card unless the caller asks for the CPU); frozen for
    serving unless ``trainable``."""
    device = resolve_device(device)

    def convert(tree):
        return {k: convert(v) if isinstance(v, dict) else _to_tensor(v, device) for k, v in tree.items()}

    return DecoderLM(cfg, convert(np_tree), trainable)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(model: DecoderLM) -> Dict:
    """The model's parameters as the reference's tree of numpy arrays, the
    per-period parameters stacked back along a leading axis."""
    return _nest(stack_by_reference_key(model.named_parameters(), _to_numpy))


def opt_state_from_reference(np_opt: Dict, model: DecoderLM) -> Dict:
    """The reference's optimizer state (numpy leaves: ``m`` and ``v`` trees
    like the parameters', and ``step``) as the port's, on the model's
    device, each moment in the dtype it arrives in."""
    dev = model.device
    names = [n for n, _ in model.named_parameters()]
    return {
        "m": {n: _to_tensor(_lookup(np_opt["m"], n), dev) for n in names},
        "v": {n: _to_tensor(_lookup(np_opt["v"], n), dev) for n in names},
        "step": torch.tensor(int(np.asarray(np_opt["step"])), dtype=torch.int32, device=dev),
    }


def opt_state_to_numpy(opt_state: Dict) -> Dict:
    """The port's optimizer state as the reference's tree of numpy arrays
    (bf16 moments as f32 arrays)."""
    return {
        "m": _nest(stack_by_reference_key(opt_state["m"].items(), _to_numpy)),
        "v": _nest(stack_by_reference_key(opt_state["v"].items(), _to_numpy)),
        "step": np.asarray(opt_state["step"].cpu().numpy(), dtype=np.int32),
    }
