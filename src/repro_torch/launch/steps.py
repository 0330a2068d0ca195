"""Step-function builders: the port of ``repro.launch.steps``
(``make_train_step``, ``make_prefill_step``, ``make_decode_step``,
``make_encoder_step``, ``step_for_cell``, the mesh context, the activation
spec and ``auto_microbatches``).  Each builder closes over the config (and
the sharding rules) and returns a function of the model and tensors only.

With ``rules`` (over a ``DeviceMesh`` of the current process group) the
steps run SPMD, one process a rank.  Each takes the global batch and keeps
the slice ``input_shardings`` gives its mesh coordinate (every rank the
whole batch where it divides no data axis, as ``make_mesh_context`` says);
``params`` is a ``ShardedLM``, which gathers each period's parameters on use
and keeps the ``model`` shard of every leaf a layer splits over that axis;
the decode state follows ``state_shardings`` (``sharding.shard_state``).
Every rules-aware step — prefill, decode, encode and train — runs
tensor-parallel on ``model`` (``models/parallel.py``): attention on its H/m
query heads and the kv heads they read, the dense MLP on its d_ff/m, the
SSM on its H_ssm/m heads (flash and the SSD scan run on those heads in
serving), each row-parallel product's f32 partial sums all-reduced over
the model group, and the MoE experts split over ``model``; a layer whose
heads or d_ff the model axis does not divide runs whole on every rank of
its model group.  Where the model axis divides the vocabulary, the
embedding lookup, the head and the CE run on each rank's V/m vocabulary
rows (``parallel.vocab_split``), and the serving steps gather the logit
columns over the model group, so they return this rank's rows of the
whole-V f32 logits, as one process does; elsewhere ``embed`` and ``head``
run whole on every rank, as do the norms.  The serving steps return this
rank's slice of their outputs; the train step reduces each gradient back to
its shard (``sharding._GatherOnUse``), updates the shards and returns the
loss of the global batch (each rank's loss divided by the global label
count, so masked labels weigh as in the reference).  Every collective is a c10d one: no
step reaches a DTensor redistribution.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.distributed.sharding import (
    P,
    ShardingRules,
    _greedy_batch_axes,
    _sum_axes,
    from_local,
    input_shardings,
    local_part,
    shard_state,
)
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.parallel import MeshContext, vocab_gather
from repro_torch.training.optimizer import OptSettings, adamw_update


def _fitting_batch_axes(rules: ShardingRules, global_batch: int) -> tuple:
    return tuple(_greedy_batch_axes(rules, global_batch)[0])


def make_mesh_context(
    rules: Optional[ShardingRules], cfg: ArchConfig, global_batch: int
) -> Optional[MeshContext]:
    """MeshContext for the sharded MoE block and the tensor-parallel layers
    (None without rules, or where neither is there: no MoE and a model axis
    of 1): only the fsdp axes that evenly divide the batch are used as
    batch axes (batch=1 long-context decode runs with a fully replicated
    token set inside the MoE)."""
    if rules is None or ("moe" not in cfg.mlp_pattern and rules.model_size == 1):
        return None
    axes = _fitting_batch_axes(rules, global_batch)
    return MeshContext(rules.mesh, batch_axes=axes, model_axis=rules.model_axis)


def act_partition_spec(rules: Optional[ShardingRules], global_batch: int) -> Optional[tuple]:
    """Activation spec (B, S, d): batch over the fitting fsdp axes."""
    if rules is None:
        return None
    axes = _fitting_batch_axes(rules, global_batch)
    return P(axes or None, None, None)


def auto_microbatches(
    cfg: ArchConfig, shape: ShapeConfig, rules: Optional[ShardingRules],
    act_budget_bytes: float = 3e9,
) -> int:
    """Gradient-accumulation factor so the per-device remat-saved activation
    carries (n_layers x microbatch_local x S x d x 2B) fit the budget (the
    reference's 3e9 bytes, so the two pick the same factor)."""
    if rules is None:
        return 1
    dp = 1
    for a in _fitting_batch_axes(rules, shape.global_batch):
        dp *= rules.axis_size(a)
    local_b = shape.global_batch // dp
    per_layer = shape.seq_len * cfg.d_model * 2  # bf16 carry per sample
    n = 1
    while (
        n < local_b
        and local_b % (2 * n) == 0
        and cfg.n_layers * (local_b // n) * per_layer > act_budget_bytes
    ):
        n *= 2
    return n


def _local_batch(rules: ShardingRules, cfg: ArchConfig, batch: Dict) -> Dict:
    """This rank's slice of a global batch dict."""
    specs = input_shardings(rules, cfg, batch)
    return {k: local_part(v, specs[k], rules.mesh) for k, v in batch.items()}


def _sum_over(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the mesh axes ``axes``."""
    import torch.distributed as dist

    t = t.clone()
    for a in axes:
        dist.all_reduce(t, group=mesh.get_group(a))
    return t


def loss_and_grads(
    params,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    remat_policy: str = "minimal",
    microbatches: int = 1,
    rules: Optional[ShardingRules] = None,
):
    """``jax.value_and_grad(M.train_loss)`` over the batch: (loss, grads by
    parameter name).  ``microbatches`` > 1 takes the reference's slices of
    the batch, accumulates the gradients in f32 and averages them with the
    losses, as the reference's scan does; with one microbatch the gradients
    stay in the parameters' dtype.

    With ``rules``, ``params`` is a ``ShardedLM`` and ``batch`` the global
    batch: each microbatch is the reference's slice of it, of which this
    rank takes its rows, and its loss on this rank is the masked sum over
    those rows divided by the label count of the whole microbatch (read
    from the global labels, which every rank holds), so the ranks' losses
    sum to the reference's loss whatever labels are masked where.  The
    gradients are this rank's shards', summed over the batch axes
    (``sharding._GatherOnUse``); the loss is the global one, on every
    rank."""
    named = list(params.named_parameters())
    B = next(iter(batch.values())).shape[0]
    ctx = make_mesh_context(rules, cfg, B)
    axes = () if rules is None else _sum_axes(rules.mesh, _fitting_batch_axes(rules, B))
    specs = None if rules is None else input_shardings(rules, cfg, batch)

    def loss_of(mb):
        if rules is None:
            return M.train_loss(params, cfg, mb, remat_policy)
        local = {k: local_part(v, specs[k], rules.mesh) for k, v in mb.items()}
        count = M.label_count(mb["labels"]).to(params.device)
        return M.train_loss(params.view(axes), cfg, local, remat_policy, ctx, count)

    def total(loss):
        return loss if not axes else _sum_over(loss, rules.mesh, axes)

    if microbatches == 1:
        loss = loss_of(batch)
        loss.backward()
        return total(loss.detach()), {n: p.grad for n, p in named}
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named}
    loss = torch.zeros((), dtype=torch.float32, device=params.device)
    for i in range(microbatches):
        loss_i = loss_of({k: x.chunk(microbatches)[i] for k, x in batch.items()})
        loss_i.backward()
        for n, p in named:
            grads[n].add_(p.grad)
            p.grad = None
        loss = loss + loss_i.detach()
    for g in grads.values():
        g.div_(microbatches)
    return total(loss) / microbatches, grads


def make_train_step(
    cfg: ArchConfig,
    settings: OptSettings,
    rules: Optional[ShardingRules] = None,
    global_batch: int = 0,
    remat_policy: str = "minimal",
    microbatches: int = 1,
):
    """fwd+bwd+AdamW: ``loss_and_grads`` then ``adamw_update``.  The step
    updates the model and the optimizer state in place and returns
    ``(loss, params, opt_state)``, loss a 0-dim f32 tensor on the model's
    device.  With ``rules``, ``params`` is a ``ShardedLM`` (trainable) and
    ``opt_state`` its ``adamw_init``: the step takes the global batch, of
    which each rank runs its rows of each microbatch, updates its shards and
    returns the loss of the global batch, the same on every rank.
    ``global_batch`` is the reference's argument; the step reads the batch
    size from the batch."""

    def train_step(params, opt_state: Dict, batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(params, cfg, batch, remat_policy, microbatches, rules)
        params, opt_state = adamw_update(params, grads, opt_state, settings)
        for p in params.parameters():
            p.grad = None
        return loss, params, opt_state

    return train_step


def make_prefill_step(
    cfg: ArchConfig, rules: Optional[ShardingRules] = None, global_batch: int = 0
):
    """``prefill_step(params, batch)`` -> (last-position logits f32 (B, V),
    decode state), ``M.prefill`` without gradients.  With ``rules``: this
    rank's rows of the logits (every column, gathered over ``model`` where
    the vocabulary splits), and the state laid out by ``state_shardings``."""
    ctx = make_mesh_context(rules, cfg, global_batch)

    @torch.no_grad()
    def prefill_step(params: M.DecoderLM, batch: Dict[str, torch.Tensor]):
        if rules is None:
            return M.prefill(params, cfg, batch)
        logits, state = M.prefill(params.view(), cfg, _local_batch(rules, cfg, batch), ctx)
        return vocab_gather(logits, cfg, ctx), shard_state(rules, cfg, state, global_batch)

    return prefill_step


def make_decode_step(
    cfg: ArchConfig, rules: Optional[ShardingRules] = None, global_batch: int = 0
):
    """``serve_step(params, state, tokens, cache_pos)`` -> (logits f32
    (B, V), new state), ``M.decode_step`` without gradients; the caches in
    ``state`` are written in place.  With ``rules``: ``tokens`` is the
    global (B, 1), and the logits are this rank's rows, every column."""
    ctx = make_mesh_context(rules, cfg, global_batch)

    @torch.no_grad()
    def serve_step(params: M.DecoderLM, state, tokens: torch.Tensor, cache_pos: int):
        if rules is None:
            return M.decode_step(params, cfg, tokens, state, cache_pos)
        caches, kv_len = state
        logits, (caches, new_len) = M.decode_step(
            params.view(), cfg, _local_batch(rules, cfg, {"tokens": tokens})["tokens"],
            (caches, kv_len.to_local()), cache_pos, ctx)
        return vocab_gather(logits, cfg, ctx), (
            caches, from_local(new_len, rules.mesh, kv_len.placements, kv_len.shape))

    return serve_step


def make_encoder_step(
    cfg: ArchConfig, rules: Optional[ShardingRules] = None, global_batch: int = 0
):
    """Encoder-only 'prefill': ``encode_step(params, batch)`` -> per-frame
    logits f32 (B, S, V), the full forward without remat and no cache
    (with ``rules``, this rank's rows, every column)."""
    ctx = make_mesh_context(rules, cfg, global_batch)

    @torch.no_grad()
    def encode_step(params: M.DecoderLM, batch: Dict[str, torch.Tensor]):
        if rules is not None:
            batch = _local_batch(rules, cfg, batch)
        model = params.view()
        hidden, _ = M.forward(model, cfg, batch, ctx, remat=False)
        return vocab_gather(M.lm_head(model, cfg, hidden, ctx), cfg, ctx)

    return encode_step


def step_for_cell(
    cfg: ArchConfig,
    shape: ShapeConfig,
    rules: Optional[ShardingRules] = None,
    settings: Optional[OptSettings] = None,
    microbatches: Optional[int] = None,
    remat_policy: str = "minimal",
):
    """(step_fn, takes_params_and_opt, microbatches) for one cell;
    ``microbatches`` defaults to ``auto_microbatches``."""
    B = shape.global_batch
    if shape.kind == "train":
        settings = settings or OptSettings.auto(cfg.param_count())
        if microbatches is None:
            microbatches = auto_microbatches(cfg, shape, rules)
        step = make_train_step(cfg, settings, rules, B, remat_policy=remat_policy,
                               microbatches=microbatches)
        return step, True, microbatches
    if shape.kind == "prefill":
        if cfg.is_encoder:
            return make_encoder_step(cfg, rules, B), False, 1
        return make_prefill_step(cfg, rules, B), False, 1
    return make_decode_step(cfg, rules, B), False, 1
