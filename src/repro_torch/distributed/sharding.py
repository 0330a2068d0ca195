"""Sharding rules: parameter / optimizer / activation / decode-state partition
specs for a (pod, data, model) mesh.  The port of
``repro.distributed.sharding``.

Scheme (MaxText-style 2-D sharding), as in the reference:
  * tensor parallel on ``model``: attention q/kv projections sharded on the
    flattened head dim, MLP on d_ff, MoE experts on E (expert parallelism),
    vocab on V;
  * FSDP on (``pod``, ``data``): the *other* matrix dim of every large
    parameter (and its optimizer moments) is sharded across the batch axes.

Every rule is applied *best-effort*: a dim is only sharded if the axis size
divides it (``_fit``), so odd published shapes degrade to replication of
that dim.

A spec is a plain tuple with one entry per leading dim of the tensor:
``None`` (replicated), an axis name, or a tuple of names (the dim split over
their product, the first axis major).  Mesh sizes are read by axis name
(``launch.mesh.mesh_sizes``), so the rules run on a stand-in mesh as well
as on a ``DeviceMesh``.  ``placements`` turns a spec into DTensor
placements, ``local_slices`` gives the index slices a mesh coordinate
holds.

``ShardedLM`` stores a model's parameters as ``param_shardings`` lays them
out, each rank holding only its shards, and gathers each period's leaves on
use, which is the gather-on-use FSDP the reference gets from GSPMD; the
MoE expert leaves keep their ``model`` shard (the sharded ``moe_block``
takes the local experts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Block, DecoderLM, param_shapes


def P(*entries) -> tuple:
    """A partition spec (see the module docstring)."""
    return tuple(entries)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object  # a DeviceMesh, or a stand-in with ``shape`` (dict) and ``axis_names``
    fsdp_axes: Tuple[str, ...]  # ("pod","data") or ("data",)
    model_axis: str = "model"
    fsdp_params: bool = True  # False => pure TP (params replicated over data)

    def axis_size(self, axis: str) -> int:
        return mesh_sizes(self.mesh)[axis]

    @property
    def fsdp_size(self) -> int:
        n = 1
        for a in self.fsdp_axes:
            n *= self.axis_size(a)
        return n

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    def _fit(self, dim: int, axes, size: int):
        """axes if they evenly divide dim, else None (replicate)."""
        return axes if dim % size == 0 else None

    def tp(self, dim: int):
        return self._fit(dim, self.model_axis, self.model_size)

    def fsdp(self, dim: int):
        if not self.fsdp_params:
            return None
        return self._fit(dim, self.fsdp_axes, self.fsdp_size)

    def matrix(self, rows: int, cols: int, tp_dim: int) -> tuple:
        """2-D param (rows, cols); ``tp_dim`` says which dim is TP."""
        if tp_dim == 1:
            return P(self.fsdp(rows), self.tp(cols))
        return P(self.tp(rows), self.fsdp(cols))


def _leaf_spec(rules: ShardingRules, cfg: ArchConfig, path: Tuple[str, ...], leaf) -> tuple:
    """Spec for one parameter leaf, identified by its tree path.

    Stacked layer params carry a leading n_periods axis (never sharded).
    """
    name = path[-1]
    shape = leaf.shape
    stacked = path[0] == "stack"
    dims = shape[1:] if stacked else shape  # strip period axis
    lead = (None,) if stacked else ()

    def out(*spec):
        return P(*lead, *spec)

    # ---- embeddings / head -------------------------------------------------
    if name == "embed":
        return P(rules.tp(shape[0]), rules.fsdp(shape[1]))  # (V, d)
    if name == "head":
        return P(rules.fsdp(shape[0]), rules.tp(shape[1]))  # (d, V)
    if name in ("final_norm",):
        return P(None)

    # ---- norms / small vectors --------------------------------------------
    if name.startswith("norm") or name in ("gate_norm", "A_log", "D", "dt_bias", "conv_b"):
        return out(*([None] * len(dims)))
    if name in ("bq", "bk", "bv"):
        return out(rules.tp(dims[0]))

    # ---- attention ----------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        return out(rules.fsdp(dims[0]), rules.tp(dims[1]))
    if name == "wo":
        return out(rules.tp(dims[0]), rules.fsdp(dims[1]))

    # ---- dense MLP ----------------------------------------------------------
    if name in ("w_gate", "w_up", "w_down") and len(dims) == 2:
        if name == "w_down":
            return out(rules.tp(dims[0]), rules.fsdp(dims[1]))
        return out(rules.fsdp(dims[0]), rules.tp(dims[1]))

    # ---- MoE (leading E dim -> expert parallelism on model) ----------------
    if name == "router":
        return out(rules.fsdp(dims[0]), None)
    if name in ("w_gate", "w_up", "w_down") and len(dims) == 3:
        return out(rules.tp(dims[0]), rules.fsdp(dims[1]), None)

    # ---- SSM ----------------------------------------------------------------
    if name == "in_proj":
        return out(rules.fsdp(dims[0]), rules.tp(dims[1]))
    if name == "out_proj":
        return out(rules.tp(dims[0]), rules.fsdp(dims[1]))
    if name == "conv_w":
        return out(None, rules.tp(dims[1]))

    return out(*([None] * len(dims)))  # default: replicate


def _tree_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _map_paths(tree, fn, prefix=()) -> Dict:
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    return {
        k: _map_paths(v, fn, prefix + (k,)) if isinstance(v, dict) else fn(prefix + (k,), v)
        for k, v in tree.items()
    }


def param_shardings(rules: ShardingRules, cfg: ArchConfig, shapes: Dict) -> Dict:
    """Spec tree matching a param (or opt-moment) shape tree."""
    return _map_paths(shapes, lambda path, leaf: _leaf_spec(rules, cfg, path, leaf))


# ---------------------------------------------------------------------------
# Inputs / activations / decode state
# ---------------------------------------------------------------------------
def _greedy_batch_axes(rules: ShardingRules, batch_dim: int):
    """fsdp axes that evenly divide the batch (prefix-greedy); remainder axes."""
    axes_b, b = [], batch_dim
    for a in rules.fsdp_axes:
        n = rules.axis_size(a)
        if b % n == 0:
            axes_b.append(a)
            b //= n
    leftover = [a for a in rules.fsdp_axes if a not in axes_b]
    return axes_b, leftover


def batch_spec(rules: ShardingRules, global_batch: int, extra_dims: int = 1) -> tuple:
    """Spec for a (B, ...) input: batch over as many fsdp axes as divide."""
    axes, _ = _greedy_batch_axes(rules, global_batch)
    return P(tuple(axes) or None, *([None] * extra_dims))


def input_shardings(rules: ShardingRules, cfg: ArchConfig, batch: Dict) -> Dict:
    """Specs for a host batch dict (tokens/labels/embeds)."""
    return {k: batch_spec(rules, v.shape[0], extra_dims=v.ndim - 1) for k, v in batch.items()}


def _fill_axes(rules: ShardingRules, dim: int, axes) -> list:
    """The axes, in order, that keep dividing ``dim``."""
    out = []
    for a in axes:
        n = rules.axis_size(a)
        if dim % n == 0:
            out.append(a)
            dim //= n
    return out


def kv_cache_spec(rules: ShardingRules, batch_dim: int, seq_dim: int, kv_heads: int) -> tuple:
    """(B, S, KV, hd) KV-cache spec.

    Batch over the fsdp axes that fit.  The ``model`` axis (plus any fsdp
    axis batch couldn't use, e.g. long_500k's batch=1) then shards KV heads
    when divisible, else the *sequence*."""
    axes_b, leftover = _greedy_batch_axes(rules, batch_dim)
    kv_axes, s_axes = [], []
    kv, s = kv_heads, seq_dim
    for a in leftover + [rules.model_axis]:
        n = rules.axis_size(a)
        if kv % n == 0:
            kv_axes.append(a)
            kv //= n
        elif s % n == 0:
            s_axes.append(a)
            s //= n
    return P(tuple(axes_b) or None, tuple(s_axes) or None, tuple(kv_axes) or None, None)


def ssm_state_spec(rules: ShardingRules, batch_dim: int, n_heads: int) -> tuple:
    """(B, H, P, N) SSD-state spec: batch over fitting fsdp axes, heads over
    the model axis (+ unused fsdp axes) when divisible."""
    axes_b, leftover = _greedy_batch_axes(rules, batch_dim)
    h_axes = _fill_axes(rules, n_heads, leftover + [rules.model_axis])
    return P(tuple(axes_b) or None, tuple(h_axes) or None, None, None)


def state_shardings(rules: ShardingRules, cfg: ArchConfig, state_shapes) -> tuple:
    """Specs for the decode state: (cache spec tree, kv_len spec).

    Cache leaves are stacked (n_periods, B, S, KV, hd) / (n_periods, B, ...).
    """
    caches, kv_len = state_shapes

    def spec_for(path, leaf):
        name = path[-1]
        if name in ("k", "v"):
            _, B, S, KV, hd = leaf.shape
            return P(None, *kv_cache_spec(rules, B, S, KV))
        if name == "state":
            _, B, H, Pd, N = leaf.shape
            return P(None, *ssm_state_spec(rules, B, H))
        # conv tail (n_periods, B, K-1, C): batch + channel best-effort
        _, B, K1, C = leaf.shape
        axes_b, leftover = _greedy_batch_axes(rules, B)
        c_axes = _fill_axes(rules, C, leftover + [rules.model_axis])
        return P(None, tuple(axes_b) or None, None, tuple(c_axes) or None)

    return _map_paths(caches, spec_for), batch_spec(rules, kv_len.shape[0], extra_dims=0)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------
def placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on each
    axis that splits tensor dim ``d``, ``Replicate()`` elsewhere.  A dim
    split over several axes must name them in mesh order (the first major),
    which is the only order DTensor lays them out in."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        where = [names.index(a) for a in _axes(entry)]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: dim {dim} names its axes out of mesh order {names}")
        for i in where:
            out[i] = Shard(dim)
    return out


def local_slices(spec: Sequence, shape: Sequence[int], mesh_shape: Dict[str, int], coord) -> tuple:
    """The index slices of a ``shape`` tensor laid out by ``spec`` that the
    mesh coordinate ``coord`` (one index per axis of ``mesh_shape``, in its
    order) holds; a dim past the spec's end is replicated."""
    at = dict(zip(mesh_shape, coord))
    out = []
    for dim, size in enumerate(shape):
        n, i = 1, 0
        for a in _axes(spec[dim] if dim < len(spec) else None):
            i = i * mesh_shape[a] + at[a]
            n *= mesh_shape[a]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over {n} shards ({spec})")
        step = size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def local_part(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` (a view)."""
    return t[local_slices(spec, t.shape, mesh_sizes(mesh), mesh.get_coordinate())]


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, mesh, places, shape):
    """A DTensor of global ``shape`` from this rank's shard, no collective."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, places, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute(t: torch.Tensor, spec: Sequence, mesh):
    """``t`` (the same on every rank) as a DTensor laid out by ``spec``: each
    rank keeps its shard and drops the rest, with no collective."""
    return from_local(local_part(t, spec, mesh).contiguous(), mesh, placements(spec, mesh), t.shape)


def _kept(places, keep_dims) -> list:
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard() and p.dim in keep_dims else Replicate() for p in places]


def gather(dt, keep_dims: Sequence[int] = ()) -> torch.Tensor:
    """The local tensor of ``dt`` gathered over every mesh axis but those
    that split a dim in ``keep_dims``."""
    return dt.redistribute(dt.device_mesh, _kept(dt.placements, keep_dims)).to_local()


def _period_dtensor(dt, p: int):
    """Period ``p``'s slice of a DTensor stacked over periods (dim 0, never
    sharded), as a DTensor over this rank's view of it."""
    from torch.distributed.tensor import Shard

    places = [Shard(q.dim - 1) if q.is_shard() else q for q in dt.placements]
    return from_local(dt.to_local()[p], dt.device_mesh, places, dt.shape[1:])


# ---------------------------------------------------------------------------
# A model stored sharded
# ---------------------------------------------------------------------------
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


class ShardedLM:
    """A ``DecoderLM``'s parameters laid out as ``param_shardings`` says, each
    rank holding only its shards (DTensors), one set per period: the period
    axis is never sharded.  It reads as a ``DecoderLM`` to the model code:
    ``embed``, ``head`` and ``final_norm`` are gathered on each access, and
    iterating ``layers`` gathers one period's leaves at a time and drops
    them when the loop moves on.  A MoE position's expert leaves are
    gathered over every axis but the one splitting E, so each rank holds
    its ``n_experts / model_size`` experts, as the sharded ``moe_block``
    wants.  ``cache_periods`` does the same for a decode state laid out by
    ``state_shardings`` (``shard_state``)."""

    def __init__(self, model: DecoderLM, rules: ShardingRules):
        self.cfg, self.rules = model.cfg, rules
        mesh = rules.mesh
        specs = param_shardings(rules, self.cfg, param_shapes(self.cfg))
        self._top = {
            name: distribute(t.detach(), specs[name], mesh)
            for name, t in model.named_parameters() if "." not in name
        }
        self._periods = []
        for period in model.layers:
            tree = {}
            for pos, blk in period.items():
                spec = specs["stack"][pos]
                tree[pos] = _map_paths(_nested(blk), lambda path, t, spec=spec: distribute(
                    t.detach(), _lookup(spec, path)[1:], mesh))
            self._periods.append(tree)

    @property
    def device(self) -> torch.device:
        return self._top["final_norm"].to_local().device

    @property
    def embed(self):
        return gather(self._top["embed"]) if "embed" in self._top else None

    @property
    def head(self) -> torch.Tensor:
        return gather(self._top["head"])

    @property
    def final_norm(self) -> torch.Tensor:
        return gather(self._top["final_norm"])

    @property
    def layers(self):
        moe = {f"pos{i}" for i, kind in enumerate(self.cfg.mlp_pattern) if kind == "moe"}

        def take(pos, path, dt):
            expert = pos in moe and path[0] == "mlp" and path[-1] in _EXPERT_LEAVES
            return gather(dt, keep_dims=(0,) if expert else ())

        for tree in self._periods:
            yield nn.ModuleDict({
                pos: Block(_map_paths(sub, lambda path, dt, pos=pos: take(pos, path, dt)))
                for pos, sub in tree.items()
            })

    def cache_periods(self, caches: Dict):
        """Each period's caches gathered over every axis but the batch's;
        after the caller has written into them (and asked for the next
        period), this rank's shards take the writes back."""
        for p in range(self.cfg.n_periods):
            views = _map_paths(caches, lambda path, dt: _period_dtensor(dt, p))
            full = _map_paths(views, lambda path, dt: gather(dt, keep_dims=(0,)))
            yield full
            for path, dt in _tree_paths(views):
                back = from_local(_lookup(full, path), dt.device_mesh,
                                  _kept(dt.placements, (0,)), dt.shape)
                dt.to_local().copy_(back.redistribute(dt.device_mesh, dt.placements).to_local())


def _nested(blk: Block) -> Dict:
    """A block's parameters as the reference's nested tree."""
    out: Dict = {}
    for name, t in blk.named_parameters():
        *keys, leaf = name.split(".")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def _lookup(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def shard_state(rules: ShardingRules, cfg: ArchConfig, state, global_batch: int):
    """A decode state built on this rank's slice of the batch (as the
    rules-aware prefill makes it) laid out by ``state_shardings``: each
    rank keeps its shards of the caches, and ``kv_len`` its batch slice."""
    caches, kv_len = state
    mesh = rules.mesh

    def global_shape(t):
        return (t.shape[0], global_batch, *t.shape[2:])

    specs, kv_spec = state_shardings(
        rules, cfg, (_map_paths(caches, lambda path, t: torch.empty(global_shape(t), device="meta")),
                     torch.empty((global_batch,), device="meta")))

    def shard(path, t):
        places = placements(_lookup(specs, path), mesh)
        return from_local(t, mesh, _kept(places, (1,)), global_shape(t)).redistribute(mesh, places)

    return _map_paths(caches, shard), from_local(kv_len, mesh, placements(kv_spec, mesh), (global_batch,))
