"""Mixture-of-Experts FFN: top-k routing with capacity-based token dropping.
The PyTorch port of ``repro.models.moe``, local path.

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

The sharded path (experts split over the ``model`` mesh axis, one
``psum``) waits for the multi-GPU slice (ROADMAP.md queue A).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dot_f32


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


def _moe_local(params, x_flat: torch.Tensor, cfg: ArchConfig, capacity: int) -> torch.Tensor:
    """Every expert over the local tokens, summed into one f32 (T, d)
    accumulator in expert-id order."""
    topk_idx, topk_w = router_probs(x_flat, params["router"], cfg.top_k)
    acc = torch.zeros(x_flat.shape, dtype=torch.float32, device=x_flat.device)
    for e in range(cfg.n_experts):
        w = _expert_weight(topk_idx, topk_w, e)
        idx, out = _expert_select_compute(
            x_flat,
            w,
            params["w_gate"][e],
            params["w_up"][e] if cfg.mlp_act == "swiglu" else params["w_gate"][e],
            params["w_down"][e],
            capacity,
            cfg.mlp_act,
        )
        acc.index_add_(0, idx, out)
    return acc


def moe_block(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    ctx=None,
    capacity_factor: Optional[float] = None,
) -> torch.Tensor:
    """MoE FFN. params: router (d,E), w_gate/w_up (E,d,f), w_down (E,f,d).

    ``ctx`` is the reference's mesh context; only a model axis of 1 (or
    none) runs here."""
    if ctx is not None and ctx.model_size > 1:
        raise NotImplementedError(
            f"moe_block over a model axis of {ctx.model_size}: the sharded MoE path is not "
            "ported yet (ROADMAP.md queue A, the multi-GPU slice)"
        )
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    y = _moe_local(params, x_flat, cfg, _capacity(B * S, cfg, capacity_factor))
    return y.to(x.dtype).reshape(B, S, d)


def moe_param_shapes(cfg: ArchConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_down": (E, f, d)}
    if cfg.mlp_act == "swiglu":
        shapes["w_up"] = (E, d, f)
    return shapes


def moe_reference(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Oracle: dense all-experts compute in f32, exact top-k combine, NO
    capacity limit.  moe_block converges to this as capacity_factor -> inf."""
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
