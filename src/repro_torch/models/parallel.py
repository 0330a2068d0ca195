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

The MLP and the SSM split only where the model axis divides their d_ff or
heads (``mlp_split``, ``ssm_split``); otherwise they run whole on every
rank of the model group, on gathered weights.  Attention splits wherever
every rank keeps a query head (``attn_split``): the rank at model
coordinate r takes ⌈H/m⌉ or ⌊H/m⌋ contiguous heads, the first H mod m
ranks one more (``head_range``), and runs its core once on each run of
heads with one q-to-kv mapping (``head_runs``).  Where m divides H and a
rank's heads make one run (``attn_even``) its ``wq`` columns and ``wo``
rows are its model shard; otherwise they are gathered whole and the rank
takes its heads' columns and rows.  The rules are shared by the layers and by
``distributed.sharding``'s parameter layouts, which keep a split leaf's
``model`` shard instead of gathering it.

The vocabulary splits the same way (``vocab_split``), as the specs split
``embed`` (V, d) and ``head`` (d, V) on V: the rank at model coordinate r
holds rows ``[r·V/m, (r+1)·V/m)`` (``vocab_range``).  The embedding looks
up its own rows, zeros for the others' tokens, and the lookups are summed
over the group (``vocab_embed``); the head multiplies on its own columns;
the cross entropy is the Megatron vocab-parallel one (``vocab_parallel_nll``):
the row max, the sum of exponentials and the gold logit are each reduced
over the group, never the logits themselves, as the reference's docstring
says its CE lowers ("partial reductions + a small all-reduce — no vocab
gather", ``src/repro/models/model.py:323-325``).  Serving gathers the
logit columns at the end (``vocab_gather``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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

    def heads(self, n: int) -> Tuple[int, int]:
        """This rank's contiguous [h0, h1) of ``n`` attention heads under the
        uneven split (``head_range``); ``part`` where m divides ``n``."""
        return head_range(n, self.model_size, self.model_rank)


def model_size(ctx: Optional[MeshContext]) -> int:
    return 1 if ctx is None else ctx.model_size


# ---------------------------------------------------------------------------
# Which layers split over model
# ---------------------------------------------------------------------------
def head_range(n: int, m: int, r: int) -> Tuple[int, int]:
    """The [h0, h1) of ``n`` heads that rank ``r`` of ``m`` computes: ⌈n/m⌉
    contiguous heads on the first n mod m ranks, ⌊n/m⌋ on the others
    (deepseek-coder's 56 on 16: 4 on ranks 0-7, 3 on ranks 8-15)."""
    step, extra = divmod(n, m)
    lo = r * step + min(r, extra)
    return lo, lo + step + (r < extra)


def attn_split(cfg: ArchConfig, m: int) -> bool:
    """Attention runs on this rank's ``head_range`` of the query heads,
    wherever every rank of the model axis keeps at least one (m ≤ H)."""
    return 1 < m <= cfg.n_heads


def attn_even(cfg: ArchConfig, m: int) -> bool:
    """The even split: m divides the query heads and a rank's H/m heads read
    whole kv groups or share one (H/m a multiple or a divisor of the group
    size H/KV), so they make one run.  ``wq``/``bq`` columns and ``wo`` rows
    then keep their model shard, which is exactly this rank's heads.
    Otherwise (``attn_split`` but not even) they are gathered whole and the
    rank takes its heads' columns and rows."""
    if m == 1 or cfg.n_heads % m:
        return False
    per_rank, group = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    return per_rank % group == 0 or group % per_rank == 0


def kv_split(cfg: ArchConfig, m: int) -> bool:
    """``wk/wv/bk/bv`` keep their model shard, which is then exactly the kv
    heads this rank's query heads read; otherwise they are gathered and the
    rank takes the columns of the kv heads it reads."""
    return attn_even(cfg, m) and cfg.n_kv_heads % m == 0


def kv_heads_read(cfg: ArchConfig, h0: int, h1: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) that query heads [h0, h1) read (head h reads h
    // (H / KV)): one contiguous run for any contiguous [h0, h1)."""
    group = cfg.n_heads // cfg.n_kv_heads
    return h0 // group, (h1 - 1) // group + 1


def head_runs(cfg: ArchConfig, h0: int, h1: int) -> List[Tuple[int, int]]:
    """Query heads [h0, h1) cut into at most three runs, each with one
    q-to-kv mapping, so the attention core runs once a run on views of q, K
    and V: a leading part of a GQA group (it reads one kv head, G = its
    length), the whole groups after it (the usual h // G), and a trailing
    part of a group (one kv head).  Empty runs are left out, so heads that
    fall inside one group, or that are whole groups, make one run."""
    group = cfg.n_heads // cfg.n_kv_heads
    a = min(h1, -(-h0 // group) * group)  # the first group boundary at or past h0
    b = max(a, h1 // group * group)  # the last one at or before h1
    return [(lo, hi) for lo, hi in ((h0, a), (a, b), (b, h1)) if hi > lo]


def mlp_split(cfg: ArchConfig, m: int) -> bool:
    """The dense MLP runs on d_ff/m a rank."""
    return m > 1 and cfg.d_ff % m == 0


def ssm_split(cfg: ArchConfig, m: int) -> bool:
    """The SSM runs on H_ssm/m heads a rank (one group of B and C, which
    every rank reads whole; ``out_proj`` rows keep their model shard)."""
    return m > 1 and cfg.ssm_heads % m == 0 and cfg.ssm_groups == 1


def vocab_split(cfg: ArchConfig, m: int) -> bool:
    """``embed`` rows and ``head`` columns keep their model shard, and the
    lookup, the head product and the CE run on V/m a rank, where m divides
    the vocabulary (mamba2's 50280 and hubert's 504 do not divide 16: they
    stay whole on every rank)."""
    return m > 1 and cfg.vocab % m == 0


def vocab_ctx(cfg: ArchConfig, ctx: Optional[MeshContext]) -> Optional[MeshContext]:
    """``ctx`` where the vocabulary splits over its model axis, else None."""
    return ctx if ctx is not None and vocab_split(cfg, ctx.model_size) else None


def vocab_range(cfg: ArchConfig, ctx: MeshContext, held: int, what: str) -> Tuple[int, int]:
    """This rank's vocabulary rows [lo, hi); raises unless ``held`` (the
    rows or columns of the leaf it was handed) is exactly V/m, so a whole
    leaf never passes for a shard."""
    lo, hi = ctx.part(cfg.vocab)
    if held != hi - lo:
        raise ValueError(f"{what} holds {held} of the vocabulary, a rank's share is {hi - lo}")
    return lo, hi


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


# ---------------------------------------------------------------------------
# The vocabulary split over model
# ---------------------------------------------------------------------------
def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig,
                ctx: MeshContext) -> torch.Tensor:
    """The embedding lookup on this rank's rows of ``table`` (V/m, d):
    each token outside them gives zeros, and the group's lookups are summed
    forward (one of them holds each row, so the sum is the lookup exactly);
    the backward is the identity, since every rank goes on with the same
    sum, and each rank's rows take the gradient of its own tokens."""
    lo, hi = vocab_range(cfg, ctx, table.shape[0], "embed")
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    x = table[local.clamp(0, hi - lo - 1)]
    return out_of_region(torch.where(inside[..., None], x, torch.zeros_like(x)), ctx)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig,
                       ctx: MeshContext) -> torch.Tensor:
    """``logsumexp(logits) − logits[label]`` over the whole vocabulary, per
    position, from this rank's f32 columns ``logits`` (..., V/m) (the
    Megatron form): the row max, detached and all-reduced MAX (the loss does
    not depend on it); ``Σ exp(logit − max)`` summed over the group; the gold
    logit taken where this rank holds the label's column, 0 elsewhere and
    for a masked label (< 0), summed over the group.  Both sums have the
    identity backward (every rank holds them whole), so each rank's columns
    take the softmax gradient of their own share."""
    import torch.distributed as dist

    lo, hi = vocab_range(cfg, ctx, logits.shape[-1], "the head")
    top = logits.detach().amax(dim=-1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=ctx.model_group)
    total = out_of_region(torch.exp(logits - top[..., None]).sum(dim=-1), ctx)
    local = labels - lo
    inside = (local >= 0) & (local < hi - lo)
    gold = torch.gather(logits, -1, local.clamp(0, hi - lo - 1)[..., None]).squeeze(-1)
    gold = out_of_region(torch.where(inside, gold, torch.zeros_like(gold)), ctx)
    return torch.log(total) + top - gold


def vocab_gather(logits: torch.Tensor, cfg: ArchConfig, ctx: Optional[MeshContext]) -> torch.Tensor:
    """Serving logits over the whole vocabulary: this rank's columns joined
    over the model group in rank order where the vocabulary splits, else
    ``logits`` as they are."""
    vctx = vocab_ctx(cfg, ctx)
    return logits if vctx is None else gather_over_model(logits, vctx, logits.ndim - 1)
