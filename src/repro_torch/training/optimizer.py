"""AdamW over the port's parameters, written out by hand: the port of
``repro.training.optimizer``.

``torch.optim.AdamW`` with ``clip_grad_norm_`` computes another update: its
clip has another epsilon and it keeps the moments in the parameters' dtype.
Here, as in the reference, the clip scales by ``grad_clip / max(norm, 1e-9)``
from a global norm taken in f32, the bias correction uses the step, weight
decay (``wd·p``) joins the update before the ``lr`` scale, and the moments are
stored in ``moment_dtype``.  The update runs leaf by leaf and in place where
the math allows, so no f32 copy of the whole tree ever exists.

The optimizer state keeps the reference's keys ``m``, ``v`` and ``step``;
``m`` and ``v`` map each parameter name of the ``DecoderLM`` to its moment
(``repro_torch.weights`` carries them to and from the reference's tree).

On a ``distributed.sharding.ShardedLM`` (sharded training) the same code
runs on each rank's shards: ``named_parameters`` yields the shards, so the
moments have each leaf's own layout, as the reference's inherit each
parameter's sharding; only the global norm needs the other ranks, and the
model takes it (``grad_norm``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.model import DecoderLM
from repro_torch.models.model import global_norm as _global_norm  # noqa: F401 (its name here)


@dataclasses.dataclass(frozen=True)
class OptSettings:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" for >=50B models

    @classmethod
    def auto(cls, n_params: int) -> "OptSettings":
        return cls(moment_dtype="bfloat16" if n_params >= 50e9 else "float32")


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays this parameter: it decays every leaf of
    rank > 1 in its tree, where a per-period parameter (``layers.{p}...``) is
    a slice of a leaf stacked over periods, one rank higher.  So the norm
    scales inside the stack are decayed and ``final_norm`` is not.  A shard
    has its leaf's rank, so it gets its leaf's answer."""
    return p.ndim + (1 if name.startswith("layers.") else 0) > 1


def adamw_init(params, settings: OptSettings) -> Dict:
    """Zero moments in ``moment_dtype`` for a ``DecoderLM`` or the shards of
    a ``ShardedLM``, and step 0."""
    dt = getattr(torch, settings.moment_dtype)
    named = list(params.named_parameters())
    zeros = lambda: {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in named}  # noqa: E731
    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=params.device)}


def opt_state_shapes(param_shapes: Dict, settings: OptSettings) -> Dict:
    """Meta-tensor mirror of the optimizer state over a reference-layout
    tree of parameter shapes (``param_shapes(cfg)``) — no allocation."""
    dt = getattr(torch, settings.moment_dtype)

    def struct(tree):
        return {
            k: struct(v) if isinstance(v, dict) else torch.empty(v.shape, dtype=dt, device="meta")
            for k, v in tree.items()
        }

    return {
        "m": struct(param_shapes),
        "v": struct(param_shapes),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


@torch.no_grad()
def adamw_update(
    params, grads: Dict[str, torch.Tensor], opt_state: Dict, settings: OptSettings
) -> Tuple[DecoderLM, Dict]:
    """One AdamW step, updating ``params`` (a ``DecoderLM`` or a
    ``ShardedLM``) and the moments in place.  Math in f32; parameters and
    moments are stored back in their dtypes.  ``grads`` maps each parameter
    name to its gradient (any float dtype), a shard's for a ``ShardedLM``."""
    step = opt_state["step"] + 1
    gnorm = params.grad_norm(grads)
    clip = torch.clamp_max(settings.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1, b2, wd = settings.beta1, settings.beta2, settings.weight_decay
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    for name, p in params.named_parameters():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].float() * clip  # a new f32 tensor, the leaf's scratch
        m32, v32 = m.float(), v.float()  # the moments themselves when f32
        t = g * (1 - b2)
        v32.mul_(b2).add_(t.mul_(g))  # v = b2 v + ((1 - b2) g) g
        m32.mul_(b1).add_(g.mul_(1 - b1))  # m = b1 m + (1 - b1) g
        update = torch.div(m32, c1, out=g).div_(torch.div(v32, c2, out=t).sqrt_().add_(settings.eps))
        p32 = p.float()  # the parameter itself when f32
        if decays(name, p):
            update.add_(torch.mul(p32, wd, out=t))
        p32.sub_(update.mul_(settings.lr))
        for stored, new in ((p, p32), (m, m32), (v, v32)):
            if new is not stored:
                stored.copy_(new)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}
