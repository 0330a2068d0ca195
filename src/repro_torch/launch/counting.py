"""What one step of one rank does, counted by running it once: the port's
replacement for the reference's post-SPMD HLO walker
(``repro.launch.hlo_analysis``), whose input PyTorch has no counterpart of.

    out, counts = count_step(step, *args)

runs ``step(*args)`` under ``torch.utils.flop_counter.FlopCounterMode`` and
a dispatch mode of its own, and counts three things over every aten op the
step dispatches (forward, the recompute of remat regions and backward):

  * FLOPs, as ``FlopCounterMode`` counts them (the matrix products and
    attention; elementwise work counts 0, as in the reference's dots);
  * eager HBM bytes: the bytes of every tensor input plus every tensor
    output of every op that is not a view.  This is an UNFUSED UPPER BOUND:
    eager PyTorch does move these bytes, but a fused program (or a tensor
    already in cache) would move fewer.  It is not the reference's fused
    traffic model;
  * collective operand bytes of every all-gather, all-reduce, reduce-scatter
    and all-to-all over a group of more than one rank, the reference's
    definition (``launch/roofline.py``): an op's operand is its input, the
    whole input of a reduce-scatter and the shard of an all-gather.

The step can run on real tensors (on the card) or on fake tensors of a fake
process group (the dry-run).  Counts are per rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# collective op name (``_c10d_functional`` and ``c10d`` namespaces) -> (kind,
# index of its input argument)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "all_reduce": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 1),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")


@dataclasses.dataclass
class Counts:
    """One rank's counts for one step."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    collectives: Dict[str, Dict]  # kind -> {"count", "operand_bytes"}


def _bytes(args) -> int:
    from torch.distributed.tensor import DTensor

    n = 0
    for t in tree_leaves(args):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def _group_size(func, args) -> int:
    """The size of the process group a collective op runs over, read from
    the argument its schema names: a functional collective's group name, or
    a c10d op's ProcessGroup."""
    from torch.distributed.distributed_c10d import ProcessGroup, _resolve_process_group

    for arg, a in zip(func._schema.arguments, args):
        if arg.name == "group_name":
            return _resolve_process_group(a).size()
        if "ProcessGroup" in str(arg.type):
            return ProcessGroup.unbox(a).size()
    raise ValueError(f"{func}: no process group among its arguments")


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.collectives: Dict[str, Dict] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func._schema.name.split("::")[-1]
            if name in _COLLECTIVES:
                kind, i = _COLLECTIVES[name]
                if _group_size(func, args) > 1:
                    c = self.collectives.setdefault(kind, {"count": 0, "operand_bytes": 0})
                    c["count"] += 1
                    c["operand_bytes"] += _bytes(args[i])
            return out
        if not func.is_view:
            self.hbm_bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def count_step(step, *args, **kwargs):
    """(``step(*args, **kwargs)``, its ``Counts``)."""
    flops = FlopCounterMode(display=False)
    ops = _OpCounter()
    with flops, ops:
        out = step(*args, **kwargs)
    coll = sum(c["operand_bytes"] for c in ops.collectives.values())
    return out, Counts(flops=float(flops.get_total_flops()), hbm_bytes=float(ops.hbm_bytes),
                       collective_bytes=float(coll), collectives=ops.collectives)
