"""Tensor parallelism on the ``model`` mesh axis: the mesh context the model
code reads, the split rules, and the collectives at a parallel region's
edges.

The reference's sharding specs split attention's ``wq/wk/wv`` on their
columns and ``wo`` on its rows, the dense MLP on d_ff, and the SSM's
``in_proj`` columns and ``out_proj`` rows over ``model``
(``src/repro/distributed/sharding.py:95-118``), and GSPMD partitions the
products to match: each rank computes its own heads and its own d_ff slice,
with one all-reduce after each row-parallel product.  Here that is written
out as the Megatron pair: ``_ToModelRegion`` on the way in (identity
forward; the input's cotangent summed over the model group backward) and
``_FromModelRegion`` on the way out (the partial sums all-reduced forward;
identity backward).  The row-parallel products all-reduce their f32
partial sums and cast after, as GSPMD places the all-reduce on the f32
result of the reference's ``preferred_element_type=f32`` einsum.

A mixer or MLP splits only where the model axis divides its heads or d_ff
(``attn_split``, ``kv_split``, ``mlp_split``, ``ssm_split``); otherwise it
runs whole on every rank of the model group, on gathered weights.  The
rules are shared by the layers and by ``distributed.sharding``'s parameter
layouts, which keep a split leaf's ``model`` shard instead of gathering it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """How model code sees the device mesh (None => single-process local):
    the ``DeviceMesh``, the axes the batch is split over, and the model
    axis, whose process group the tensor-parallel layers and the sharded
    ``moe_block`` combine over."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"

    @property
    def model_size(self) -> int:
        return mesh_sizes(self.mesh)[self.model_axis]

    @property
    def model_group(self):
        return self.mesh.get_group(self.model_axis)

    @property
    def model_rank(self) -> int:
        return self.mesh.get_local_rank(self.model_axis)

    def part(self, n: int) -> Tuple[int, int]:
        """This rank's contiguous [lo, hi) of ``n`` things split over model."""
        step = n // self.model_size
        return self.model_rank * step, (self.model_rank + 1) * step


def model_size(ctx: Optional[MeshContext]) -> int:
    return 1 if ctx is None else ctx.model_size


# ---------------------------------------------------------------------------
# Which layers split over model
# ---------------------------------------------------------------------------
def attn_split(cfg: ArchConfig, m: int) -> bool:
    """Attention runs on H/m query heads a rank (``wq``/``bq`` columns and
    ``wo`` rows keep their model shard), where m divides the heads and a
    rank's heads read whole kv heads or share one (its H/m heads a multiple
    or a divisor of the group size H/KV): its kv heads are then one
    contiguous run, ``kv_heads_read``."""
    if m == 1 or cfg.n_heads % m:
        return False
    per_rank, group = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    return per_rank % group == 0 or group % per_rank == 0


def kv_split(cfg: ArchConfig, m: int) -> bool:
    """``wk/wv/bk/bv`` keep their model shard, which is then exactly the kv
    heads this rank's query heads read; otherwise they are gathered and the
    rank takes the columns of the kv heads it reads."""
    return attn_split(cfg, m) and cfg.n_kv_heads % m == 0


def kv_heads_read(cfg: ArchConfig, h0: int, h1: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) that query heads [h0, h1) read (head h reads h
    // (H / KV)), under ``attn_split``."""
    group = cfg.n_heads // cfg.n_kv_heads
    return h0 // group, (h1 - 1) // group + 1


def mlp_split(cfg: ArchConfig, m: int) -> bool:
    """The dense MLP runs on d_ff/m a rank."""
    return m > 1 and cfg.d_ff % m == 0


def ssm_split(cfg: ArchConfig, m: int) -> bool:
    """The SSM runs on H_ssm/m heads a rank (one group of B and C, which
    every rank reads whole; ``out_proj`` rows keep their model shard)."""
    return m > 1 and cfg.ssm_heads % m == 0 and cfg.ssm_groups == 1


# ---------------------------------------------------------------------------
# The collectives at a region's edges
# ---------------------------------------------------------------------------
class _ToModelRegion(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    group.  An input every rank of the group holds (the tokens, the
    router) reaches each rank's experts or heads, so its gradient is the
    sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromModelRegion(torch.autograd.Function):
    """The combine: ``all_reduce`` (sum) over the model group forward; the
    identity backward, since every rank goes on with the same replicated
    sum.  (``torch.distributed.nn.functional.all_reduce`` would sum the
    cotangents again, scaling every rank's gradient by the model size.)"""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverModel(torch.autograd.Function):
    """A value every rank's heads consume, summed from the ranks' partial
    sums: ``all_reduce`` forward AND backward, since each rank's cotangent
    of the sum is only its own heads' share (the gated norm's sum of
    squares)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def into_region(t: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    return _ToModelRegion.apply(t, ctx.model_group)


def out_of_region(t: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    return _FromModelRegion.apply(t, ctx.model_group)


def sum_over_model(t: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    return _SumOverModel.apply(t, ctx.model_group)


def gather_over_model(t: torch.Tensor, ctx: MeshContext, dim: int) -> torch.Tensor:
    """The ranks' ``t`` joined along ``dim`` in model-rank order (no
    gradient: the serving paths' decode writes)."""
    import torch.distributed as dist

    part = t.movedim(dim, 0).contiguous()
    whole = part.new_empty((ctx.model_size * part.shape[0], *part.shape[1:]))
    dist.all_gather_into_tensor(whole, part, group=ctx.model_group)
    return whole.movedim(0, dim)
