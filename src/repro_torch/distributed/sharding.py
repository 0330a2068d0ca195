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
use, which is the gather-on-use FSDP the reference gets from GSPMD
(``src/repro/distributed/sharding.py:7-9``); the MoE expert leaves keep
their ``model`` shard (the sharded ``moe_block`` takes the local experts),
and so do a tensor-parallel layer's split leaves and, where ``model``
divides the vocabulary, ``embed``'s rows and ``head``'s columns.
Its shards take gradients: ``_GatherOnUse`` holds the rule by which each
gradient goes back to its shard.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import DecoderLM, param_shapes
from repro_torch.models.parallel import attn_split, kv_split, mlp_split, ssm_split, vocab_split


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


def gather(dt, keep_dims: Sequence[int] = ()) -> torch.Tensor:
    """The local tensor of ``dt`` gathered over every mesh axis but those
    that split a dim in ``keep_dims``, by c10d collectives (``_gathered``)."""
    return _gathered(dt.to_local(), dt.device_mesh, _placed(dt.placements, keep_dims))


def _placed(places, keep_dims: Sequence[int] = ()) -> "_Layout":
    """The layout ``_gathered`` reads (placements and kept dims) of a tensor
    laid out by ``places``."""
    return _Layout(None, tuple(places), None, None, tuple(keep_dims), ())


def _own_part(full: torch.Tensor, mesh, places, keep_dims: Sequence[int] = ()) -> torch.Tensor:
    """This rank's part of ``full``, which ``_gathered`` joined over every
    dim ``places`` split but ``keep_dims`` (already this rank's): the
    gather's inverse, a view."""
    names = list(mesh_sizes(mesh))
    spec = [()] * full.ndim
    for i, p in enumerate(places):
        if p.is_shard() and p.dim not in keep_dims:
            spec[p.dim] = spec[p.dim] + (names[i],)
    return full[local_slices([e or None for e in spec], full.shape, mesh_sizes(mesh),
                             mesh.get_coordinate())]


def _shift(places) -> tuple:
    """The placements of one period's slice of a leaf stacked over periods
    (dim 0, never sharded)."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(q.dim - 1) if q.is_shard() else q for q in places)


# ---------------------------------------------------------------------------
# Gather on use, and the gradient rule
# ---------------------------------------------------------------------------
# Both directions are c10d collectives over one mesh axis at a time
# (``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``):
# gloo takes them on CPU and CUDA tensors, NCCL on CUDA tensors, and the
# dry-run's fake group under ``FakeTensorMode``.  (DTensor's all-gather, a
# functional collective, killed a gloo rank on CUDA tensors on the card.)
@dataclasses.dataclass(frozen=True)
class _Layout:
    """How one parameter leaf is laid out: its spec, DTensor placements and
    global shape and dtype, the dims a gather leaves split (the MoE
    experts' E, a tensor-parallel leaf's heads or d_ff), the mesh axes that
    split it, and the axes its gradient is summed over besides the batch's
    (``model`` for a leaf gathered whole of which the ranks of a model group
    read different columns)."""

    spec: tuple
    places: tuple
    shape: tuple
    dtype: torch.dtype
    keep: tuple
    split_axes: tuple
    summed_over: tuple = ()  # axes its gradient sums over whatever the batch


def _sum_axes(mesh, axes) -> tuple:
    sizes = mesh_sizes(mesh)
    return tuple(a for a in axes if sizes[a] > 1)


def _gathered_dim(layout: _Layout, mesh, i: int):
    """The dim of the leaf that mesh axis ``i`` splits and a gather joins,
    or None."""
    p = layout.places[i]
    if p.is_shard() and p.dim not in layout.keep and mesh.size(i) > 1:
        return p.dim
    return None


def _gathered(local: torch.Tensor, mesh, layout: _Layout) -> torch.Tensor:
    """``local`` gathered over every mesh axis that splits it but a kept
    dim's, the last axis first: a dim split over several axes is laid out
    first-axis-major."""
    import torch.distributed as dist

    t = local
    for i in reversed(range(mesh.ndim)):
        dim = _gathered_dim(layout, mesh, i)
        if dim is not None:
            part = t.movedim(dim, 0).contiguous()
            whole = part.new_empty((mesh.size(i) * part.shape[0], *part.shape[1:]))
            dist.all_gather_into_tensor(whole, part, group=mesh.get_group(i))
            t = whole.movedim(0, dim)
    return local if t is local else t.contiguous()


def _reduced(grad: torch.Tensor, mesh, layout: _Layout, sum_axes: tuple) -> torch.Tensor:
    """The gradient of a gathered leaf brought back to this rank's shard,
    the first axis first (the gather's inverse): over an axis of
    ``sum_axes`` summed (reduce-scatter where the axis splits the leaf,
    all-reduce where it replicates it), over any other axis sliced."""
    import torch.distributed as dist

    g, coord = grad, mesh.get_coordinate()
    for i, axis in enumerate(mesh_sizes(mesh)):
        dim, n = _gathered_dim(layout, mesh, i), mesh.size(i)
        if axis in sum_axes and dim is not None:
            part = g.movedim(dim, 0).contiguous()
            out = part.new_empty((part.shape[0] // n, *part.shape[1:]))
            dist.reduce_scatter_tensor(out, part, group=mesh.get_group(i))
            g = out.movedim(0, dim)
        elif axis in sum_axes:
            g = g.clone(memory_format=torch.contiguous_format)  # never the caller's cotangent
            dist.all_reduce(g, group=mesh.get_group(i))
        elif dim is not None:
            step = g.shape[dim] // n
            g = g.narrow(dim, coord[i] * step, step)
    return g.contiguous()


class _GatherOnUse(torch.autograd.Function):
    """A leaf's shard gathered for use, with the gradient rule of sharded
    training.  (An autograd Function rather than DTensor's ``to_local(
    grad_placements=...)``, so the gradient rule is the c10d code of
    ``_reduced``, on every backend.)

    Forward: the shard gathered over every mesh axis but those that split a
    kept dim.

    Backward: the cotangent is this rank's gradient of ITS OWN loss with
    respect to the gathered leaf; each rank's loss is the masked sum of its
    own rows divided by the count of the GLOBAL batch's labels
    (``launch.steps.loss_and_grads``), so the global loss is the sum of the
    ranks' losses.  DTensor's default (``to_local()`` takes the gradient as
    Replicate on every axis) would only slice it back to the shard: each
    data rank would keep the gradient of its own rows and drop the others',
    a wrong update and no error.  The rule:
      * over ``sum_axes``, the batch axes that split the batch, the ranks saw
        different rows: the gradient is SUMMED over them (a reduce-scatter
        where the leaf is split on the axis, an all-reduce where it is
        replicated);
      * over ``model``, and over a data axis the batch does not divide (every
        rank then takes the whole batch), every rank computed the same
        gradient: it is SLICED, never summed.  The sharded ``moe_block``
        already sums its token and router cotangents over ``model``;
      * a kept dim (E of the MoE experts, a tensor-parallel leaf's heads or
        d_ff, ``embed``'s and ``head``'s vocabulary rows, split on
        ``model``) stays split: each rank's cotangent is that of its own
        experts, heads or rows, summed over the batch axes only;
      * a leaf gathered whole of which the ranks of a model group read
        different columns (``_Layout.summed_over``: a tensor-parallel
        layer's ``wk/wv`` whose kv heads do not split over ``model``, the
        SSM's ``in_proj``, conv and per-head leaves) is SUMMED over
        ``model`` too: each rank's cotangent covers only the columns its
        heads read, and ranks overlap where they share a kv head or B/C.
    """

    @staticmethod
    def forward(ctx, local, mesh, layout: _Layout, sum_axes: tuple):
        ctx.meta = (mesh, layout, sum_axes)
        t = _gathered(local.detach(), mesh, layout)
        return local.view_as(local) if t is local else t

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, *ctx.meta), None, None, None


def gather_on_use(local: torch.Tensor, mesh, layout: _Layout, sum_axes: tuple):
    """A leaf's shard gathered for use: through ``_GatherOnUse`` where a
    gradient is wanted, a plain gather otherwise."""
    if local.requires_grad and torch.is_grad_enabled():
        return _GatherOnUse.apply(local, mesh, layout, sum_axes)
    return _gathered(local, mesh, layout)


# ---------------------------------------------------------------------------
# A model stored sharded
# ---------------------------------------------------------------------------
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
_SSM_READ_BY_HEAD = ("in_proj", "conv_w", "conv_b", "gate_norm", "A_log", "D", "dt_bias")


def _model_rule(cfg: ArchConfig, m: int, mixer: str, mlp: str, path: Tuple[str, ...]) -> tuple:
    """(kept dims, whether the gradient sums over ``model``) of one period
    leaf, by its path under the position: what the tensor-parallel layers
    (``models/parallel.py``) read of it."""
    part, name = path[0], path[-1]
    if part == "mixer" and mixer == "attn" and attn_split(cfg, m):
        if name in ("wq", "wk", "wv"):
            return ((1,), False) if name == "wq" or kv_split(cfg, m) else ((), True)
        if name in ("bq", "bk", "bv", "wo"):
            return ((0,), False) if name in ("bq", "wo") or kv_split(cfg, m) else ((), True)
    if part == "mixer" and mixer == "ssm" and ssm_split(cfg, m):
        if name == "out_proj":
            return (0,), False
        if name in _SSM_READ_BY_HEAD:
            return (), True
    if part == "mlp" and mlp == "mlp" and mlp_split(cfg, m) and name in _EXPERT_LEAVES:
        return ((0,) if name == "w_down" else (1,)), False
    if part == "mlp" and mlp == "moe" and name in _EXPERT_LEAVES:
        return (0,), False
    return (), False


def _leaf_layouts(cfg: ArchConfig, rules: ShardingRules) -> Dict[str, _Layout]:
    """The layout of every parameter, by ``DecoderLM`` parameter name and in
    its order: a per-period parameter takes its stacked leaf's spec without
    the period axis, and keeps its ``model`` shard where ``_model_rule``
    says, and ``embed`` its rows and ``head`` its columns where the model
    axis divides the vocabulary (``parallel.vocab_split``; a kept dim's spec
    is exactly ``model``)."""
    mesh = rules.mesh
    names = list(mesh_sizes(mesh))
    m = rules.model_size
    shapes = param_shapes(cfg)
    specs = param_shardings(rules, cfg, shapes)

    def layout(spec, leaf, shape, keep=(), summed=False):
        places = tuple(placements(spec, mesh))
        split = tuple(a for a, p in zip(names, places) if p.is_shard() and mesh_sizes(mesh)[a] > 1)
        for d in keep:
            if _axes(spec[d]) != (rules.model_axis,):
                raise ValueError(f"a kept dim {d} of {tuple(shape)} is laid out {spec}, not on model")
        return _Layout(tuple(spec), places, tuple(shape), leaf.dtype, keep, split,
                       (rules.model_axis,) if summed else ())

    out = {}
    vocab_dim = {"embed": 0, "head": 1} if vocab_split(cfg, m) else {}
    for name in ("embed", "head", "final_norm"):
        if name in shapes:
            keep = (vocab_dim[name],) if name in vocab_dim else ()
            out[name] = layout(specs[name], shapes[name], shapes[name].shape, keep)
    for p in range(cfg.n_periods):
        for pos, sub in shapes["stack"].items():
            i = int(pos[3:])
            for path, leaf in _tree_paths(sub):
                keep, summed = _model_rule(cfg, m, cfg.period[i], cfg.mlp_pattern[i], path)
                out[".".join(("layers", str(p), pos, *path))] = layout(
                    _lookup(specs["stack"][pos], path)[1:], leaf, leaf.shape[1:], keep, summed)
    return out


class ShardedLM:
    """A ``DecoderLM``'s parameters laid out as ``param_shardings`` says, each
    rank holding only its shards, one set per period (the period axis is
    never sharded).

    ``named_parameters()`` yields each shard under its ``DecoderLM`` name, a
    leaf that takes gradients when ``trainable``: the optimizer's moments and
    the checkpoint reach every shard by that name.  ``view()`` is what the
    model code reads: it gathers ``embed``, ``head`` and ``final_norm`` once
    (over the fsdp axes only where the vocabulary splits over ``model``: each
    rank keeps its V/m rows), and each period's leaves only when the period
    code asks for a position, inside its remat region, so the backward
    gathers again and only shards outlive a period (GSPMD's gather on use
    under ``remat_policy="minimal"``).
    A MoE position's expert leaves are gathered over every axis but the one
    splitting E, so each rank holds its ``n_experts / model_size`` experts,
    as the sharded ``moe_block`` wants.  ``cache_periods`` does the same for
    a decode state laid out by ``state_shardings`` (``shard_state``)."""

    def __init__(self, model: DecoderLM, rules: ShardingRules, trainable: bool = False):
        full = dict(model.named_parameters())
        self._setup(model.cfg, rules, trainable,
                    lambda name, lay: local_part(full[name].detach(), lay.spec, rules.mesh).clone())

    @classmethod
    def empty(cls, cfg: ArchConfig, rules: ShardingRules, device, trainable: bool = False) -> "ShardedLM":
        """Uninitialised shards, never a whole leaf: under ``FakeTensorMode``
        the dry-run's model, which allocates nothing."""
        self = cls.__new__(cls)
        sizes, coord = mesh_sizes(rules.mesh), rules.mesh.get_coordinate()

        def shard(name, lay):
            sl = local_slices(lay.spec, lay.shape, sizes, coord)
            return torch.empty([s.stop - s.start for s in sl], dtype=lay.dtype, device=device)

        self._setup(cfg, rules, trainable, shard)
        return self

    def _setup(self, cfg, rules, trainable, shard) -> None:
        self.cfg, self.rules, self.mesh = cfg, rules, rules.mesh
        self._layout = _leaf_layouts(cfg, rules)
        self._local = {name: shard(name, lay).requires_grad_(trainable)
                       for name, lay in self._layout.items()}
        self._positions = [{} for _ in range(cfg.n_periods)]  # period -> pos -> [(path, name)]
        for name in self._local:
            if name.startswith("layers."):
                _, p, pos, *path = name.split(".")
                self._positions[int(p)].setdefault(pos, []).append((tuple(path), name))

    def named_parameters(self):
        return iter(self._local.items())

    def parameters(self):
        return iter(self._local.values())

    @property
    def device(self) -> torch.device:
        return self._local["final_norm"].device

    def slices(self, name: str) -> tuple:
        """The index slices of the whole leaf ``name`` this rank holds."""
        lay = self._layout[name]
        return local_slices(lay.spec, lay.shape, mesh_sizes(self.mesh), self.mesh.get_coordinate())

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of which ``t`` is this rank's shard laid out like
        parameter ``name`` (the parameter or one of its moments); every rank
        of the group must ask."""
        lay = self._layout[name]
        return _gathered(t.detach(), self.mesh, dataclasses.replace(lay, keep=()))

    def view(self, sum_axes: Sequence[str] = ()):
        """What the model code reads for one forward (``_View``); ``sum_axes``
        are the batch axes that split the batch, over which the gradients
        are summed."""
        return _View(self, _sum_axes(self.mesh, sum_axes))

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global gradient norm, each element of the global gradient
        counted once: every rank sums the squares of its own shards in f32,
        grouped by the mesh axes that split the leaf, and each group's sum is
        all-reduced over exactly those axes, never over one that replicates
        the leaf (which would count the leaf once per rank of that axis)."""
        import torch.distributed as dist

        groups: Dict[tuple, list] = {}
        for name, g in grads.items():
            groups.setdefault(self._layout[name].split_axes, []).append(torch.square(g.float()).sum())
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for axes in sorted(groups):  # the same groups, in the same order, on every rank
            s = torch.stack(groups[axes]).sum()
            for a in axes:
                dist.all_reduce(s, group=self.mesh.get_group(a))
            total = total + s
        return total.sqrt()

    def _gather(self, name: str, sum_axes: tuple) -> torch.Tensor:
        lay = self._layout[name]
        return gather_on_use(self._local[name], self.mesh, lay, sum_axes + lay.summed_over)

    def cache_periods(self, caches: Dict):
        """Each period's caches as the layers read them: a leaf that
        ``_cache_keep`` keeps is this rank's shard itself (written in
        place), any other is gathered over every axis but the batch's and,
        after the caller has written into it (and asked for the next
        period), this rank's shard takes its part back.  c10d collectives
        (``_gathered``), never DTensor's."""
        for p in range(self.cfg.n_periods):
            held = {}
            for path, dt in _tree_paths(caches):
                places = _shift(dt.placements)
                held[path] = (dt.to_local()[p], places, _cache_keep(self.cfg, self.rules, path, places))
            full = {path: _gathered(local, self.mesh, _placed(places, keep))
                    for path, (local, places, keep) in held.items()}
            yield _map_paths(caches, lambda path, dt: full[path])
            for path, (local, places, keep) in held.items():
                if full[path] is not local:
                    local.copy_(_own_part(full[path], self.mesh, places, keep))


def _cache_keep(cfg: ArchConfig, rules: ShardingRules, path: Tuple[str, ...], places) -> tuple:
    """The dims of one period's decode-cache leaf (batch first) that stay
    this rank's: the batch's, and the heads' where ``model`` alone splits
    them and this rank's tensor-parallel layer reads exactly those heads
    (an attention's kv heads under ``kv_split``, an SSM's heads under
    ``ssm_split``).  The conv tail's channels are laid out contiguously,
    never as the x | B | C channels of the rank's heads: it is gathered."""
    pos, name = path[0], path[-1]
    mixer, m = cfg.period[int(pos[3:])], rules.model_size
    dim = {"k": 2, "v": 2, "state": 1}.get(name)
    tp = kv_split(cfg, m) if mixer == "attn" else ssm_split(cfg, m)
    names = list(mesh_sizes(rules.mesh))
    by = [names[i] for i, p in enumerate(places)
          if p.is_shard() and p.dim == dim and rules.mesh.size(i) > 1]
    return (0, dim) if dim is not None and tp and by == [rules.model_axis] else (0,)


class _View:
    """A ``ShardedLM`` as the model code reads a ``DecoderLM``, for one
    forward: ``embed``, ``head`` and ``final_norm`` gathered once (never
    over ``model`` where it splits the vocabulary: the rank's V/m rows), and
    ``layers`` yielding each period as a ``_Period``, which gathers a
    position's leaves when the period code asks for it."""

    def __init__(self, lm: ShardedLM, sum_axes: tuple):
        self.cfg, self.device, self.cache_periods = lm.cfg, lm.device, lm.cache_periods
        self._lm, self._sum_axes = lm, sum_axes
        for name in ("embed", "head", "final_norm"):
            setattr(self, name, lm._gather(name, sum_axes) if name in lm._local else None)

    @property
    def layers(self):
        for p in range(self.cfg.n_periods):
            yield _Period(self._lm, p, self._sum_axes)


class _Period:
    """One period of a ``ShardedLM``: ``period["pos0"]`` gathers that
    position's leaves anew on every call (a recompute gathers again)."""

    def __init__(self, lm: ShardedLM, p: int, sum_axes: tuple):
        self._lm, self._p, self._sum_axes = lm, p, sum_axes

    def __getitem__(self, pos: str):
        tree: Dict = {}
        for path, name in self._lm._positions[self._p][pos]:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self._lm._gather(name, self._sum_axes)
        return types.SimpleNamespace(**tree)


def _lookup(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _join_model(t: torch.Tensor, rules: ShardingRules, dim: int) -> torch.Tensor:
    """The model ranks' ``t`` joined along ``dim`` in rank order."""
    from torch.distributed.tensor import Replicate, Shard

    places = [Shard(dim) if a == rules.model_axis else Replicate() for a in mesh_sizes(rules.mesh)]
    return _gathered(t, rules.mesh, _placed(places))


def _whole_channels(cfg: ArchConfig, rules: ShardingRules, t: torch.Tensor) -> torch.Tensor:
    """A conv tail of this rank's channels (x of its heads, then B and C)
    joined over model into every channel (x of every head, B, C)."""
    m, di = rules.model_size, cfg.d_inner
    parts = _join_model(t, rules, t.ndim - 1).chunk(m, dim=-1)
    return torch.cat([q[..., : di // m] for q in parts] + [parts[0][..., di // m :]], dim=-1)


def shard_state(rules: ShardingRules, cfg: ArchConfig, state, global_batch: int):
    """A decode state built on this rank's slice of the batch (as the
    rules-aware prefill makes it) laid out by ``state_shardings``: each
    rank keeps its shards of the caches, and ``kv_len`` its batch slice.
    A tensor-parallel layer's cache holds this rank's heads (or channels):
    where the layout splits them over ``model`` alone it is the shard
    already, otherwise it is joined over model first.  c10d collectives,
    no DTensor redistribution."""
    caches, kv_len = state
    mesh = rules.mesh

    def whole_shape(path, t):
        return (t.shape[0], global_batch, *_cache_dims(cfg, path[-1], t.shape[2:]))

    specs, kv_spec = state_shardings(
        rules, cfg, (_map_paths(caches, lambda path, t: types.SimpleNamespace(shape=whole_shape(path, t))),
                     types.SimpleNamespace(shape=(global_batch,))))

    def shard(path, t):
        places = placements(_lookup(specs, path), mesh)
        shape = whole_shape(path, t)
        keep = (1,)
        dim = next((d for d in range(2, t.ndim) if t.shape[d] != shape[d]), None)
        if dim is not None:  # this rank's heads or channels
            if 1 + _cache_keep(cfg, rules, path, _shift(places))[-1] == dim:
                keep = (1, dim)
            elif path[-1] == "conv":
                t = _whole_channels(cfg, rules, t)
            else:
                t = _join_model(t, rules, dim)
        local = _own_part(t, mesh, places, keep)
        return from_local(local.contiguous(), mesh, places, shape)

    return _map_paths(caches, shard), from_local(kv_len, mesh, placements(kv_spec, mesh), (global_batch,))


def _cache_dims(cfg: ArchConfig, name: str, dims) -> tuple:
    """A cache leaf's trailing dims after (n_periods, B) with every head or
    channel: (S, KV, hd), (H, P, N) or (K-1, conv_dim)."""
    if name in ("k", "v"):
        return (dims[0], cfg.n_kv_heads, dims[2])
    if name == "state":
        return (cfg.ssm_heads, *dims[1:])
    return (dims[0], cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
