"""AdamW as a training job states it (``"optimizer"`` in a traffic file):
the gradient clipped to a global norm taken in float32 (scale
``grad_clip / max(norm, 1e-9)`` where below 1), moments in float32 with
bias correction, weight decay ``wd · p`` added to the update of every leaf
of more than one axis (per-layer leaves are stacked, so each layer's norm
scales decay and the final norm does not), then ``p - lr · update``, the
parameter stored back in its own dtype."""
from __future__ import annotations

from typing import Dict

import torch


class AdamW:
    def __init__(self, W: Dict[str, torch.Tensor], opt: dict):
        self.W, self.opt, self.step = W, opt, 0
        self.m = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in W.items()}
        self.v = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in W.items()}

    @staticmethod
    def clip_scale(grads: Dict[str, torch.Tensor], grad_clip: float) -> float:
        norm = torch.sqrt(sum(torch.square(g).sum() for g in grads.values()))
        return min(1.0, grad_clip / max(float(norm), 1e-9))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step; returns the gradients as the moments took them (clipped)."""
        o = self.opt
        self.step += 1
        clip = self.clip_scale(grads, o["grad_clip"])
        b1, b2 = o["beta1"], o["beta2"]
        c1, c2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        for k, p in self.W.items():
            g = grads[k].mul_(clip)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + o["eps"])
            p32 = p.float()
            if p.ndim > 1:
                upd.add_(p32, alpha=o["weight_decay"])
            p.copy_(p32 - o["lr"] * upd)
        return grads
