"""Carry parameters between the reference's tree and the port's model.

The reference keeps parameters as a nested dict with ``stack/pos{i}`` leaves
that carry a leading ``n_periods`` axis; ``jax.tree.map(np.asarray, params)``
turns it into numpy arrays.  ``params_from_reference`` builds a
``DecoderLM`` from such a tree by key path (a copy, never a transpose: both
keep the ``(in, out)`` orientation), and ``params_to_numpy`` is the inverse.

numpy has no bfloat16 of its own: a bf16 leaf arrives as whatever dtype
numpy was given (``ml_dtypes.bfloat16`` from JAX) and is read through f32,
which is exact; ``params_to_numpy`` returns bf16 leaves as f32 arrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import DecoderLM, resolve_device


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of the caller's buffer)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(np_tree: Dict, cfg: ArchConfig, device=None) -> DecoderLM:
    """The reference's parameter tree (numpy leaves) as the port's model on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def convert(tree):
        return {k: convert(v) if isinstance(v, dict) else _to_tensor(v, device) for k, v in tree.items()}

    return DecoderLM(cfg, convert(np_tree))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(model: DecoderLM) -> Dict:
    """The model's parameters as the reference's tree of numpy arrays, the
    per-period parameters stacked back along a leading axis."""
    flat: Dict[tuple, List[torch.Tensor]] = {}
    for name, param in model.named_parameters():
        parts = name.split(".")
        path = ("stack", *parts[2:]) if parts[0] == "layers" else tuple(parts)
        flat.setdefault(path, []).append(param)
    out: Dict = {}
    for path, leaves in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        value = torch.stack(leaves) if path[0] == "stack" else leaves[0]
        node[path[-1]] = _to_numpy(value)
    return out
