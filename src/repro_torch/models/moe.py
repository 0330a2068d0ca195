"""Mixture-of-Experts FFN: top-k routing with capacity-based token dropping
(the PyTorch port of ``repro.models.moe``, local path), or dropless routing
with a shared expert, which only the port has (``_moe_dropless``).

Routing is GShard-style top-k, first come first served in flattened
``B*S`` order, without the (tokens, experts, capacity) one-hot dispatch
tensors: each expert *selects* its assigned tokens with ``torch.topk`` over
an assignment score, computes a dense (capacity, d_ff) FFN and adds the
result back into one f32 accumulator with ``index_add_``.  Every shape is
static: ``k = min(capacity, T)`` is fixed, so no step waits for the host
(``nonzero`` would, once per expert per layer).

Dtype stream, as the reference's: the selected tokens stay in the model
dtype, the three products accumulate in f32 (``_dot_f32``), ``h`` is cast
back to the model dtype before ``w_down``, the experts are summed in f32 in
id order, and the sum is cast to the model dtype once, at the end.

Distribution, as the reference's: the experts are split over the ``model``
mesh axis.  The block's input is already replicated across ``model`` (every
rank of a model group holds the same batch slice), so dispatch needs no
all-to-all: each rank routes its tokens with the full router, computes the
tokens of *its* experts, and one ``all_reduce`` over the model group, in
the model dtype, combines them.  Both paths share ``_moe_local``: the
sharded one runs it over the rank's experts only, with the capacity of the
rank's own tokens.

The dropless path (``cfg.moe_dropless``, GraniteMoeHybrid's routing) keeps
every routed pair: one stable sort of the T·k (token, expert) pairs by
expert, one gather of their rows, then each expert's SwiGLU over its
contiguous slice with the dtype stream above, and each token's k rows
scaled by their weights and summed in f32 (``embedding_bag``); a shared
SwiGLU expert of ``shared_intermediate_size`` (if any) over every token
adds into the same f32 sum, cast once.  The experts'
bounds in the sorted pairs reach the host once a layer, to slice by.  Its
``model.moe.route`` span carries ``rows_max`` and ``rows_mean`` (the
busiest expert's rows and the mean over the experts) and its
``model.moe.experts`` span ``rows``, the pairs it computed (T·k).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dot_f32
from repro_torch.models.parallel import into_region, out_of_region
from repro_torch.obs.spans import span


def router_probs(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Top-k routing with renormalized combine weights.

    Returns (topk_idx (T, k) int64, topk_w (T, k) f32).
    """
    probs = torch.softmax(_dot_f32(x_flat, router_w), dim=-1)
    topk_w, topk_idx = torch.topk(probs, top_k, dim=-1)
    topk_w = topk_w / torch.clamp_min(topk_w.sum(-1, keepdim=True), 1e-9)
    return topk_idx, topk_w


def _expert_weight(topk_idx: torch.Tensor, topk_w: torch.Tensor, e: int) -> torch.Tensor:
    """Combine weight of expert ``e`` for every token (0 if not routed)."""
    return (topk_w * (topk_idx == e).to(topk_w.dtype)).sum(-1)  # (T,)


def _expert_slots(weight: torch.Tensor, capacity: int):
    """The token each of the expert's ``min(capacity, T)`` slots takes, and
    whether the slot holds an assigned token.  Earlier tokens win capacity
    (GShard FCFS): the score is T - pos for an assigned token and -1
    otherwise, so the top of it is the assigned tokens in position order."""
    T = weight.shape[0]
    pos = torch.arange(T, device=weight.device)
    score = torch.where(weight > 0, T - pos, -1)
    top_scores, idx = torch.topk(score, min(capacity, T))
    return idx, top_scores > 0


def _expert_select_compute(
    x_flat: torch.Tensor,  # (T, d)
    weight: torch.Tensor,  # (T,) combine weight for this expert (0 = unrouted)
    w_gate: torch.Tensor,  # (d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # (f, d)
    capacity: int,
    act: str,
):
    """One expert: select (<= capacity) assigned tokens and run the FFN.
    Returns (idx (C,), the weighted f32 outputs (C, d)) for the caller to add
    at ``idx``; an unassigned slot's row is zeroed by its scale."""
    idx, valid = _expert_slots(weight, capacity)
    xsel = x_flat.index_select(0, idx)  # (C, d), model dtype
    g = _dot_f32(xsel, w_gate)
    if act == "swiglu":
        h = F.silu(g) * _dot_f32(xsel, w_up)
    else:  # jax.nn.gelu is the tanh approximation
        h = F.gelu(g, approximate="tanh")
    y = _dot_f32(h.to(x_flat.dtype), w_down)
    scale = (weight.index_select(0, idx) * valid.to(torch.float32))[:, None]
    return idx, y * scale


def _capacity(n_tokens: int, cfg: ArchConfig, capacity_factor: Optional[float]) -> int:
    f = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    return max(1, int(n_tokens * cfg.top_k / cfg.n_experts * f))


def _moe_local(
    params, x_flat: torch.Tensor, cfg: ArchConfig, capacity: int, n_local: Optional[int] = None,
    e0: int = 0,
) -> torch.Tensor:
    """``n_local`` experts (all by default) starting at id ``e0`` over the
    local tokens, summed into one f32 (T, d) accumulator in expert-id
    order; ``params``' expert leaves hold just those experts."""
    n_local = cfg.n_experts if n_local is None else n_local
    topk_idx, topk_w = router_probs(x_flat, params["router"], cfg.top_k)
    acc = torch.zeros(x_flat.shape, dtype=torch.float32, device=x_flat.device)
    for i in range(n_local):
        w = _expert_weight(topk_idx, topk_w, e0 + i)
        idx, out = _expert_select_compute(
            x_flat,
            w,
            params["w_gate"][i],
            params["w_up"][i] if cfg.mlp_act == "swiglu" else params["w_gate"][i],
            params["w_down"][i],
            capacity,
            cfg.mlp_act,
        )
        acc.index_add_(0, idx, out)
    return acc


def _dot_f32_into(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """``out[...] = _dot_f32(x, w)``.  Serving on the card, the GEMM writes
    its f32 result into ``out`` itself, with no copy."""
    if not x.is_cuda or torch.is_grad_enabled():
        out.copy_(_dot_f32(x, w))
    elif x.dtype == torch.float32:
        torch.mm(x, w, out=out)
    else:
        torch.mm(x, w, out_dtype=torch.float32, out=out)


ROWS = 128  # an expert's GEMMs run over its rows rounded up to a multiple of this


def _moe_dropless(params, x_flat: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Every routed (token, expert) pair, then the shared expert, in f32.
    Each expert's products write its rows of buffers over all T·k sorted
    pairs, so the host launches three GEMMs an expert and nothing else; the
    SwiGLU between them, and each token's weighted sum over its k pairs
    (``embedding_bag`` over the pairs' f32 rows), run once over all pairs.

    An expert's GEMMs take its rows rounded up to ``ROWS``, so that their
    shapes repeat from batch to batch and the GEMM library picks no new
    kernel for each new count.  The overhang runs into the next experts'
    rows, which those experts, launched later on the same stream, write
    again; the buffers hold ``ROWS`` spare rows for the last one's."""
    T, k, E = x_flat.shape[0], cfg.top_k, cfg.n_experts
    n, dev = T * k, x_flat.device
    experts = list(zip(*(params[name].unbind(0) for name in ("w_gate", "w_up", "w_down"))))
    with span("model.moe.route") as route:
        topk_idx, topk_w = router_probs(x_flat, params["router"], k)
        # pair j is token j // k; sorted by expert, each expert's tokens in order
        pair_expert, order = torch.sort(topk_idx.reshape(-1), stable=True)
        xs = x_flat.index_select(0, F.pad(order // k, (0, ROWS)))  # the spare rows: token 0's
        # where pair j sits in the sorted order
        slot = torch.empty_like(order).index_copy_(0, order, torch.arange(n, device=dev))
        # expert e's pairs are [bounds[e], bounds[e + 1]): the layer's one host read
        bounds = torch.searchsorted(pair_expert, torch.arange(E + 1, device=dev)).tolist()
        if route is not None:
            route.attrs.update(rows_max=max(b - a for a, b in zip(bounds, bounds[1:])), rows_mean=n / E)
    busy = [(a, a - (a - b) // ROWS * ROWS, w) for w, a, b in zip(experts, bounds, bounds[1:]) if a < b]
    with span("model.moe.experts") as computed:
        gate = torch.empty((n + ROWS, cfg.d_ff), dtype=torch.float32, device=dev)
        up = torch.empty_like(gate)
        for a, b, (w_gate, w_up, _) in busy:
            _dot_f32_into(xs[a:b], w_gate, gate[a:b])
            _dot_f32_into(xs[a:b], w_up, up[a:b])
        h = (F.silu(gate) * up).to(x_flat.dtype)
        del gate, up
        y = torch.empty((n + ROWS, x_flat.shape[1]), dtype=torch.float32, device=dev)
        for a, b, (_, _, w_down) in busy:
            _dot_f32_into(h[a:b], w_down, y[a:b])
        acc = F.embedding_bag(slot.view(T, k), y, per_sample_weights=topk_w, mode="sum")
        if computed is not None:
            computed.attrs["rows"] = bounds[-1]
    if cfg.shared_intermediate_size:
        with span("model.moe.shared"):
            h = F.silu(_dot_f32(x_flat, params["shared_gate"])) * _dot_f32(x_flat, params["shared_up"])
            acc += _dot_f32(h.to(x_flat.dtype), params["shared_down"])
    return acc


def moe_block(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    ctx=None,
    capacity_factor: Optional[float] = None,
) -> torch.Tensor:
    """MoE FFN. params: router (d,E), w_gate/w_up (E,d,f), w_down (E,f,d).

    Under a ``ctx`` whose model axis is over 1, ``x`` is this rank's batch
    slice (the same on every rank of its model group) and the expert leaves
    hold this rank's ``n_experts / model_size`` experts, from
    ``model_rank * n_local`` on.  The capacity comes from the rank's own
    tokens, as the reference's shard_map body computes it, so a batch split
    over data drops tokens per data shard."""
    B, S, d = x.shape
    dt = x.dtype
    x_flat = x.reshape(B * S, d)
    if cfg.moe_dropless:
        if ctx is not None and ctx.model_size > 1:
            raise ValueError("the dropless MoE runs on one rank: its experts do not split over model")
        return _moe_dropless(params, x_flat, cfg).to(dt).reshape(B, S, d)
    cap = _capacity(B * S, cfg, capacity_factor)
    if ctx is None or ctx.model_size == 1:
        return _moe_local(params, x_flat, cfg, cap).to(dt).reshape(B, S, d)

    if cfg.n_experts % ctx.model_size != 0:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by model axis {ctx.model_size}"
        )
    n_local = cfg.n_experts // ctx.model_size
    for name in ("w_gate", "w_up", "w_down"):
        if name in params and params[name].shape[0] != n_local:
            raise ValueError(f"{name} holds {params[name].shape[0]} experts; this rank's shard is "
                             f"{n_local} of {cfg.n_experts}")
    local = dict(params)
    local["router"] = into_region(params["router"], ctx)
    y = _moe_local(local, into_region(x_flat, ctx), cfg, cap, n_local, ctx.model_rank * n_local)
    # Combine in the model dtype, as the reference's psum(y.astype(dt)):
    # each rank's partial sum is an f32 accumulation, the sum over ranks is not.
    return out_of_region(y.to(dt), ctx).reshape(B, S, d)


def moe_param_shapes(cfg: ArchConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_down": (E, f, d)}
    if cfg.mlp_act == "swiglu":
        shapes["w_up"] = (E, d, f)
    fs = cfg.shared_intermediate_size
    if fs:
        shapes.update(shared_gate=(d, fs), shared_up=(d, fs), shared_down=(fs, d))
    return shapes


def moe_reference(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Oracle: dense all-experts compute in f32, exact top-k combine, NO
    capacity limit and no shared expert.  moe_block converges to this as
    capacity_factor -> inf; the dropless path without a shared expert is
    it."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d).float()
    topk_idx, topk_w = router_probs(x_flat, params["router"].float(), cfg.top_k)
    y = torch.zeros_like(x_flat)
    for e in range(cfg.n_experts):
        g = x_flat @ params["w_gate"][e].float()
        if cfg.mlp_act == "swiglu":
            h = F.silu(g) * (x_flat @ params["w_up"][e].float())
        else:
            h = F.gelu(g, approximate="tanh")
        out = h @ params["w_down"][e].float()
        y = y + out * _expert_weight(topk_idx, topk_w, e)[:, None]
    return y.to(x.dtype).reshape(B, S, d)
